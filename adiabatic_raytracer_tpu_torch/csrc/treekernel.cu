// K3: whole forward branching trees in one kernel, f64, one thread per event.
//
// Replaces the Pallas TPU tree kernel adiabatic_raytracer_tpu/ops/
// treekernel.py _tree_kernel (via tree_kernel_launch; step body
// _make_step_body).  Thread i runs event i's tree from the node it holds in
// its rows with art::tree_run (tree_device.cuh, shared with K4), for at most
// it_cap iterations; then its whole state is in its rows, and a relaunch
// resumes it.
//
// What bounds it on the card: f64 arithmetic and divergence, as in K2 (a
// DP5 step is ~6 RHS plus 3-49 condition evaluations, a few hundred bytes
// move per event for the whole tree), and worse: an event's whole tree runs
// in one thread, so a warp waits for its slowest tree, and a 2048-event
// batch fills 16 blocks of 132 SMs.  What the design does about it: nothing
// carries between blocks; finished threads return at once (the TPU kernel's
// tile_run skip); the wrapper relaunches in bounded slices with staged
// straggler compaction (forward_tree_kernel), so late launches run only the
// events still alive, packed actives-first.  The TPU kept the queue in VMEM
// scratch; here it lives in L1/L2-cached device memory.
#include "tree_device.cuh"

using art::MegaParams;

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    tree_kernel(double* __restrict__ uio, double* __restrict__ aux,
                const double* __restrict__ uni, double* __restrict__ q,
                double* __restrict__ fin, int B, MegaParams P, TreeParams T) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  double* a = aux + (size_t)i * art::AUX_ROWS;
  if (a[art::A_DONE] > 0.5) return;  // finished event (the TPU kernel's tile_run skip)
  int used;
  art::tree_run(P, T, uio, aux, uni, q, fin, (size_t)i, T.it_cap, &used);
  a[art::A_ITERS] += 1.0;  // the launches this event ran in
}

}  // namespace

// uio [B, 16], aux [B, 32], q [B, QD * 16] (all updated in place), uni
// [B, UU], fin [B, NF * 16] (final records of this launch, F_VALID set on
// the slots written); f64, contiguous, on the device.  Threads whose
// aux[A_DONE] is set return at once.  Returns cudaGetLastError().
extern "C" int art_treekernel(double* uio, double* aux, const double* uni, double* q,
                              double* fin, int B, MegaParams P, TreeParams T, void* stream) {
  if (B <= 0) return 0;
  if (P.max_crossings != 1 || T.nf < 1 || T.qd < 1 || T.uu < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  tree_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(uio, aux, uni, q, fin, B, P, T);
  return (int)cudaGetLastError();
}
