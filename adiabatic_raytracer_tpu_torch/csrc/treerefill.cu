// K4: the refill tree engine, f64.  Every block serves one partition of up
// to `epart` events with `lanes` threads; a thread takes the next unstarted
// event of its partition from a queue in shared memory, runs its whole tree
// (art::tree_run, tree_device.cuh, K3's body), and takes the next one.
//
// Replaces the Pallas TPU kernel adiabatic_raytracer_tpu/ops/treekernel.py
// _tree_kernel_refill (via tree_refill_launch).  Per event it computes what
// K3 computes: the same rows, counters and finals; only the schedule
// differs.  The TPU kernel's mechanics are not carried over: its lanes ran
// in lockstep, so it gathered a new event's rows from a VMEM table and
// scattered the finished one's counters and finals with one-hot MXU
// matmuls, and ranked the refilling lanes with a triangular matmul.  Here a
// thread owns its event: it reads and writes the event's own rows of K3's
// block layout (that is the gather and the scatter), and a shared-memory
// atomicAdd hands out event indices (that is the rank).  The only barrier is
// the one after the queue head is set; then the threads diverge freely.
//
// `refill_k` keeps the reference's meaning: a thread whose tree ended
// advances its iteration count to the next multiple of refill_k (where the
// TPU's lanes waited for the next refill boundary), arithmetically, and
// takes its next event there.  Per-event results do not depend on it; the
// iteration budget it_cap is per thread.  aux[A_ITERS] gets the thread's
// iteration count when the event stopped.  An event that a thread could not
// finish within it_cap keeps aux[A_DONE] clear (the wrapper raises).
//
// What bounds it on the card: what bounds K3 (f64 arithmetic and divergence,
// a thread runs a whole tree), with fewer threads: a partition of 1024
// events on 128 threads fills one SM per partition.  What the design does
// about it: a thread that finishes early pulls more work instead of idling,
// so a block lasts about as long as the average thread's queue share plus
// one tree, not as long as its slowest tree.
#include "tree_device.cuh"

using art::MegaParams;

namespace {

constexpr int kMaxLanes = 128;

__global__ void __launch_bounds__(kMaxLanes)
    tree_refill_kernel(double* __restrict__ uio, double* __restrict__ aux,
                       const double* __restrict__ uni, double* __restrict__ q,
                       double* __restrict__ fin, int E, int epart, int refill_k, int it_cap,
                       MegaParams P, TreeParams T) {
  __shared__ int head;
  if (threadIdx.x == 0) head = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * epart;
  const long long left = (long long)E - base;
  const int nv = left < epart ? (int)left : epart;
  long long it = 0;  // this thread's iterations, <= it_cap < 2^31
  while (it < it_cap) {
    const int e = atomicAdd(&head, 1);
    if (e >= nv) break;
    const size_t i = (size_t)(base + e);
    double* a = aux + i * art::AUX_ROWS;
    if (a[art::A_DONE] > 0.5) continue;  // already finished: nothing to run
    int used;
    const bool done = art::tree_run(P, T, uio, aux, uni, q, fin, i, (int)(it_cap - it), &used);
    it += used;
    a[art::A_ITERS] = (double)it;
    if (!done) break;  // budget spent: the event stays live
    it = (it + refill_k - 1) / refill_k * refill_k;
  }
}

}  // namespace

// uio [E, 16], aux [E, 32], q [E, QD * 16], fin [E, NF * 16] (zeroed by the
// caller; F_VALID set on the slots written), all updated in place; uni
// [E, UU]; f64, contiguous, on the device.  Events e of partition
// p = e / epart are served by block p; lanes <= 128, refill_k >= 1,
// it_cap >= 0 per thread.  Returns cudaGetLastError().
extern "C" int art_treerefill(double* uio, double* aux, const double* uni, double* q,
                              double* fin, int E, int epart, int lanes, int refill_k, int it_cap,
                              MegaParams P, TreeParams T, void* stream) {
  if (E <= 0) return 0;
  if (P.max_crossings != 1 || T.nf < 1 || T.qd < 1 || T.uu < 1 || epart < 1 || lanes < 1 ||
      lanes > kMaxLanes || refill_k < 1 || it_cap < 0)
    return (int)cudaErrorInvalidValue;
  const int parts = (int)(((long long)E + epart - 1) / epart);
  tree_refill_kernel<<<parts, lanes, 0, (cudaStream_t)stream>>>(uio, aux, uni, q, fin, E, epart,
                                                                refill_k, it_cap, P, T);
  return (int)cudaGetLastError();
}
