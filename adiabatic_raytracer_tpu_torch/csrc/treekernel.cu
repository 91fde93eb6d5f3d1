// K3: whole forward branching trees in one kernel, f64, one warp per event.
//
// Replaces the Pallas TPU tree kernel adiabatic_raytracer_tpu/ops/
// treekernel.py _tree_kernel (via tree_kernel_launch; step body
// _make_step_body).  Warp w of block b runs event 4b + w from the node it
// holds in its rows with art::tree_run (tree_device.cuh, shared with K4), for
// at most it_cap iterations; then its whole state is in its rows, and a
// relaunch resumes it.
//
// What bounds it on the card: the latency of one tree's serial chain (a DP5
// step is 6 RHS evaluations, then 3-49 condition evaluations and a 60-step
// bisection per root; a few hundred bytes move per event for the whole
// tree), not operations or bytes.  What the design does about it: a warp
// runs one tree, so no lane waits for another tree's dense pass or
// bisection; the RHS chain runs replicated in its 32 lanes, while the event
// scan (up to 32 points a round) and the bisection (5 levels a round) are
// spread over them (tree_warp.cuh), so a step costs ~12 condition latencies
// for a root instead of ~60.  Blocks of 4 warps: at 255 registers 8 warps fit
// an SM, ~1,056 trees at once on 132 SMs.  Finished events return at once,
// as a whole warp (the TPU kernel's tile_run skip); the wrapper may relaunch
// in bounded slices with staged straggler compaction (forward_tree_kernel).
// The TPU kept the queue in VMEM scratch; here it lives in L1/L2-cached
// device memory.
#include "tree_device.cuh"

using art::MegaParams;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

__global__ void __launch_bounds__(kThreads)
    tree_kernel(double* __restrict__ uio, double* __restrict__ aux,
                const double* __restrict__ uni, double* __restrict__ q,
                double* __restrict__ fin, int B, MegaParams P, TreeParams T) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  if (i >= B) return;
  double* a = aux + (size_t)i * art::AUX_ROWS;
  if (a[art::A_DONE] > 0.5) return;  // finished event (the TPU kernel's tile_run skip)
  int used;
  art::tree_run(P, T, uio, aux, uni, q, fin, (size_t)i, T.it_cap, lane, &used);
  if (lane == 0) a[art::A_ITERS] += 1.0;  // the launches this event ran in
}

}  // namespace

// uio [B, 16], aux [B, 32], q [B, QD * 16] (all updated in place), uni
// [B, UU], fin [B, NF * 16] (final records of this launch, F_VALID set on
// the slots written); f64, contiguous, on the device.  Warps whose event has
// aux[A_DONE] set return at once.  Returns cudaGetLastError().
extern "C" int art_treekernel(double* uio, double* aux, const double* uni, double* q,
                              double* fin, int B, MegaParams P, TreeParams T, void* stream) {
  if (B <= 0) return 0;
  if (P.max_crossings != 1 || T.nf < 1 || T.qd < 1 || T.uu < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + kWarps - 1) / kWarps;
  tree_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(uio, aux, uni, q, fin, B, P, T);
  return (int)cudaGetLastError();
}
