// K4: the refill tree engine, f64.  Every partition of up to `epart` events
// is served by `warps` warps; a warp takes the next unstarted event of its
// partition from a queue in device memory, runs its whole tree
// (art::tree_run, tree_device.cuh, K3's body: one warp per tree), and takes
// the next one.
//
// Replaces the Pallas TPU kernel adiabatic_raytracer_tpu/ops/treekernel.py
// _tree_kernel_refill (via tree_refill_launch).  Per event it computes what
// K3 computes: the same rows, counters and finals; only the schedule
// differs.  The TPU kernel's mechanics are not carried over: its lanes ran
// in lockstep, so it gathered a new event's rows from a VMEM table and
// scattered the finished one's counters and finals with one-hot MXU
// matmuls, and ranked the refilling lanes with a triangular matmul.  Here a
// warp owns its event: it reads and writes the event's own rows of K3's
// block layout (that is the gather and the scatter), and lane 0's atomicAdd
// on the partition's queue head, broadcast by __shfl_sync, hands out event
// indices (that is the rank).  The heads live in device memory (`heads`,
// [parts] int32, zeroed by the caller), so a partition's warps may span
// blocks; blocks of 4 warps, no barrier.
//
// `refill_k` keeps the reference's meaning: a warp whose tree ended
// advances its iteration count to the next multiple of refill_k (where the
// TPU's lanes waited for the next refill boundary), arithmetically, and
// takes its next event there.  Per-event results do not depend on it; the
// iteration budget it_cap is per warp.  aux[A_ITERS] gets the warp's
// iteration count when the event stopped.  An event that a warp could not
// finish within it_cap keeps aux[A_DONE] clear (the wrapper raises).
//
// What bounds it on the card: what bounds K3 (the latency of one tree's
// serial chain), and at fewer warps than events the serial sum of a warp's
// trees.  What the design does about it: a warp that finishes early pulls
// the next event instead of idling, and by default the wrapper gives the
// partitions as many warps as the card holds at once.
#include "tree_device.cuh"

using art::MegaParams;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

__global__ void __launch_bounds__(kThreads)
    tree_refill_kernel(double* __restrict__ uio, double* __restrict__ aux,
                       const double* __restrict__ uni, double* __restrict__ q,
                       double* __restrict__ fin, int* __restrict__ heads, int E, int epart,
                       int warps, int refill_k, int it_cap, MegaParams P, TreeParams T) {
  const int lane = threadIdx.x & 31;
  const int per_part = (warps + kWarps - 1) / kWarps;  // blocks per partition
  const int part = blockIdx.x / per_part;
  const int wi = (blockIdx.x % per_part) * kWarps + threadIdx.x / 32;
  if (wi >= warps) return;
  const long long base = (long long)part * epart;
  const long long left = (long long)E - base;
  const int nv = left < epart ? (int)left : epart;
  long long it = 0;  // this warp's iterations, <= it_cap < 2^31
  while (it < it_cap) {
    int e = 0;
    if (lane == 0) e = atomicAdd(heads + part, 1);
    e = __shfl_sync(art::kFullMask, e, 0);
    if (e >= nv) break;
    const size_t i = (size_t)(base + e);
    double* a = aux + i * art::AUX_ROWS;
    if (a[art::A_DONE] > 0.5) continue;  // already finished: nothing to run
    int used;
    const bool done =
        art::tree_run(P, T, uio, aux, uni, q, fin, i, (int)(it_cap - it), lane, &used);
    it += used;
    if (lane == 0) a[art::A_ITERS] = (double)it;
    if (!done) break;  // budget spent: the event stays live
    it = (it + refill_k - 1) / refill_k * refill_k;
  }
}

}  // namespace

// uio [E, 16], aux [E, 32], q [E, QD * 16], fin [E, NF * 16] (zeroed by the
// caller; F_VALID set on the slots written), all updated in place; uni
// [E, UU]; f64, contiguous, on the device; heads [ceil(E / epart)] int32,
// zeroed by the caller.  Events e of partition p = e / epart are served by
// `warps` warps; refill_k >= 1, it_cap >= 0 per warp.  Returns
// cudaGetLastError().
extern "C" int art_treerefill(double* uio, double* aux, const double* uni, double* q,
                              double* fin, int* heads, int E, int epart, int warps, int refill_k,
                              int it_cap, MegaParams P, TreeParams T, void* stream) {
  if (E <= 0) return 0;
  const long long parts = ((long long)E + epart - 1) / epart;
  const long long blocks = parts * ((warps + kWarps - 1) / kWarps);
  if (P.max_crossings != 1 || T.nf < 1 || T.qd < 1 || T.uu < 1 || epart < 1 || warps < 1 ||
      refill_k < 1 || it_cap < 0 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  tree_refill_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      uio, aux, uni, q, fin, heads, E, epart, warps, refill_k, it_cap, P, T);
  return (int)cudaGetLastError();
}

// The warps K4 keeps resident at once on the current device: active blocks
// per SM (occupancy at K4's registers) x SMs x 4.
extern "C" int art_treerefill_resident_warps(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tree_refill_kernel, kThreads, 0);
  *out = per_sm * sms * kWarps;
  return (int)err;
}
