// P1: K4's queue mechanism in isolation, f32.  Every block serves one
// partition of up to `epart` events with its threads (lanes): a thread takes
// the next event of the partition from a queue head in shared memory
// (atomicAdd), reads the event's row 0 (a work quota) and row 1 (its id),
// burns the quota one unit per iteration, advances its iteration count to
// the next multiple of refill_k, and there takes its next event, as K4 does.
//
// Replaces the Pallas probe kernel of scripts/probe_refill_ops.py (the
// pallas_call at :147, kernel :47-138), which tested the TPU mechanisms K4
// needed: one-hot MXU gather and scatter, triangular-matmul lane ranks, a
// queue head carried through the loop.  On the card the same contract is an
// indexed read, an atomic scatter-add and an atomicAdd on the queue head, so
// P1 checks what can go wrong with them: a skipped or doubled event, and the
// last events' write-out when the loop ends.
//
// The output holds the probe's rows (out [parts, srows, epart], zeroed here
// as the Pallas kernel zeroes its block): the flush of event e adds its id to
// row 0, its steps to row 1 and the flush iteration to row srows-1; rows
// 2..srows-2 stay 0.  An event is flushed at the refill boundary where its
// thread takes another event, else after the loop at the loop's end: n_it
// while the queue still holds events, else the last iteration any thread
// worked.  It moves a few bytes per event: bound by launch latency.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void flush(float* o, int epart, int srows, int e, float id,
                                      float steps, int it) {
  atomicAdd(&o[e], id);
  atomicAdd(&o[epart + e], steps);
  atomicAdd(&o[(size_t)(srows - 1) * epart + e], (float)it);
}

__global__ void refill_probe_kernel(const float* __restrict__ tbl, float* __restrict__ out,
                                    int n_events, int epart, int rows, int srows, int refill_k,
                                    int n_it) {
  __shared__ int head;
  __shared__ int last;
  const long long base = (long long)blockIdx.x * epart;
  const long long left = (long long)n_events - base;
  const int nv = left < epart ? (int)left : epart;
  const float* t = tbl + (size_t)blockIdx.x * rows * epart;
  float* o = out + (size_t)blockIdx.x * srows * epart;
  for (int i = threadIdx.x; i < srows * epart; i += blockDim.x) o[i] = 0.0f;
  if (threadIdx.x == 0) {
    head = 0;
    last = 0;
  }
  __syncthreads();
  int it = 0, held = -1, end = 0;
  float held_id = 0.0f, held_steps = 0.0f;
  while (it < n_it) {
    const int e = atomicAdd(&head, 1);
    if (e >= nv) break;
    if (held >= 0) flush(o, epart, srows, held, held_id, held_steps, it);
    float work = t[e];
    held = e;
    held_id = t[epart + e];
    held_steps = 0.0f;
    while (work > 0.5f && it < n_it) {
      work -= 1.0f;
      held_steps += 1.0f;
      ++it;
    }
    end = it;
    it = (it + refill_k - 1) / refill_k * refill_k;
  }
  atomicMax(&last, end);
  __syncthreads();
  // the queue head passes nv only once a thread found the queue empty
  const int loop_end = head >= nv ? last : n_it;
  if (held >= 0) flush(o, epart, srows, held, held_id, held_steps, loop_end);
}

}  // namespace

// tbl [parts, rows, epart] f32 (row 0 quota, row 1 id), out [parts, srows,
// epart] f32; n_events = the events of all partitions (the last one may be
// short).  Returns cudaGetLastError().
extern "C" int art_refill_probe(const float* tbl, float* out, int n_events, int epart, int rows,
                                int srows, int lanes, int refill_k, int n_it, void* stream) {
  if (n_events <= 0) return 0;
  if (epart < 1 || rows < 2 || srows < 3 || lanes < 1 || lanes > 1024 || refill_k < 1 ||
      n_it < 0)
    return (int)cudaErrorInvalidValue;
  const int parts = (int)(((long long)n_events + epart - 1) / epart);
  refill_probe_kernel<<<parts, lanes, 0, (cudaStream_t)stream>>>(tbl, out, n_events, epart, rows,
                                                                 srows, refill_k, n_it);
  return (int)cudaGetLastError();
}
