// K1: the conversion-surface sampler's dense line scan, f32.
//
// Replaces the Pallas TPU kernel adiabatic_raytracer_tpu/ops/pallas_kernels.py
// line_scan_pallas (_kernel, _condition_block): the thick-surface
// level-crossing condition at every point of B straight sampling lines,
// out[b, n] = line_condition(x0[b] + s[n] * vvec[b]; vloc[b], erg[b]).
//
// What bounds it on the card: arithmetic.  Each point costs ~100 f32 flops
// (about 10 of them sqrt/div) and writes 4 bytes, so at 3.35 TB/s the store
// stream is far below the ALU time; there is no reduction and no reuse
// beyond the 10 per-line parameters.
// What the design does about it: one thread per (line, point) on a 2-D grid,
// 256 consecutive points of one line per block, so stores coalesce; the 10
// line parameters are loaded once per block into shared memory; no
// transcendentals but sqrt (the azimuthal trig comes from Cartesian ratios).
#include "physics.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void line_scan_kernel(const float* __restrict__ params,
                                 const float* __restrict__ s_grid, float* __restrict__ out,
                                 int B, int N, art::LineScene S) {
  __shared__ float par[10];
  const int n = blockIdx.x * kThreads + threadIdx.x;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    __syncthreads();
    if (threadIdx.x < 10) par[threadIdx.x] = params[(size_t)b * 10 + threadIdx.x];
    __syncthreads();
    if (n < N) {
      const float s = s_grid[n];
      out[(size_t)b * N + n] = art::line_condition(
          par[0] + s * par[3], par[1] + s * par[4], par[2] + s * par[5], par[6], par[7],
          par[8], par[9], S);
    }
  }
}

}  // namespace

// params [B, 10] (x0, vvec, vloc, erg), s_grid [N], out [B, N]; all f32,
// contiguous, on the device.  Launches on `stream`; returns cudaGetLastError().
extern "C" int art_line_scan(const float* params, const float* s_grid, float* out, int B,
                             int N, art::LineScene S, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid((N + kThreads - 1) / kThreads, B < 65535 ? B : 65535);
  line_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(params, s_grid, out, B, N, S);
  return (int)cudaGetLastError();
}
