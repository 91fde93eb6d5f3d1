// K1: the conversion-surface sampler's line scan, two kernels.
//
// Both replace the Pallas TPU kernel adiabatic_raytracer_tpu/ops/
// pallas_kernels.py line_scan_pallas (_kernel, _condition_block): the
// thick-surface level-crossing condition at every point of B straight
// sampling lines, g[b, n] = line_condition(x0[b] + s[n] * vvec[b]; vloc[b],
// erg[b]), in f32.
//
// art_line_scan, the grid kernel, writes g [B, N], the TPU function's
// output.  One thread per (line, point) on a 2-D grid, 256 consecutive
// points of one line per block, so stores coalesce; the 10 line parameters
// are loaded once per block into shared memory.
//
// art_line_roots, the fused kernel (the sampler's path), returns what the
// sampler makes of g (ops/sampler._roots): each line's first 16 sign
// changes, bisected 50 times and filtered, without g leaving the chip.  One
// warp per line, 8 warps a block, warps striding over lines:
//   * scan: 32 points a round (~70 rounds at N = 2221), through the grid
//     kernel's own device function (art::line_point_condition), so the two
//     scans agree bit for bit; the left neighbour by __shfl_up_sync, lane
//     0's from the previous round's last value (carry); a flip is
//     sign(g[n-1]) * sign(g[n]) < 0 (zeros and NaNs are none); the flips of
//     a round by __ballot_sync, their ranks by __popc, and the first 16 of
//     the line, in line order, with the value at their left point, into the
//     warp's slots in shared memory;
//   * bisection: lane j < min(count, 16) bisects slot j's interval 50 times
//     in T (float or double; the sampler's compute dtype) on the T copies of
//     the line parameters and grid, keeping the half whose left end has
//     g_lo's sign, and filters its root s* (art::line_accept);
//   * outputs s_star [B, 16] (T; 0 where the slot holds no root), ok
//     [B, 16] (has a root and passes the filter), n_flips [B] (int32, all
//     of the line's flips) and, when asked, slot_idx [B, 16] (each slot's
//     left grid index, -1 past the count).
//
// What bounds them on the card: arithmetic.  A point costs ~130 f32
// operations (about 10 of them sqrt or div); the grid kernel writes 4 bytes
// a point, the fused one ~84 bytes a line in f32 (8.9 KB less at N = 2221).
// A bisected root adds 50 evaluations in T, in at most 16 lanes of its
// warp.
#include <cstdint>

#include "physics.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kMaxC = 16;        // ops/sampler.py MAX_LINE_CROSSINGS
constexpr int kRootWarps = 8;    // warps a block of the fused kernel

__global__ void line_scan_kernel(const float* __restrict__ params,
                                 const float* __restrict__ s_grid, float* __restrict__ out,
                                 int B, int N, art::LineScene S) {
  __shared__ float par[10];
  const int n = blockIdx.x * kThreads + threadIdx.x;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    __syncthreads();
    if (threadIdx.x < 10) par[threadIdx.x] = params[(size_t)b * 10 + threadIdx.x];
    __syncthreads();
    if (n < N) out[(size_t)b * N + n] = art::line_point_condition<float>(par, s_grid[n], S);
  }
}

// torch.sign: +1, -1, or 0 for a zero and for a NaN
template <typename T>
__device__ __forceinline__ int sign_of(T a) {
  return a > T(0) ? 1 : (a < T(0) ? -1 : 0);
}

template <typename T>
__global__ void __launch_bounds__(kRootWarps * 32)
    line_roots_kernel(const float* __restrict__ par32, const float* __restrict__ s32,
                      const T* __restrict__ parT, const T* __restrict__ sT, int B, int N,
                      int bisect, art::LineScene S32, art::LineSceneT<T> ST,
                      T* __restrict__ s_star, uint8_t* __restrict__ ok,
                      int* __restrict__ n_flips, int* __restrict__ slot_idx) {
  __shared__ int slot_n[kRootWarps][kMaxC];
  __shared__ float slot_g[kRootWarps][kMaxC];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  for (int b = blockIdx.x * kRootWarps + w; b < B; b += gridDim.x * kRootWarps) {
    float par[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) par[k] = par32[(size_t)b * 10 + k];
    float carry = 0.f;
    int count = 0;
    for (int base = 0; base < N; base += 32) {
      const int n = base + lane;
      const float g = n < N ? art::line_point_condition<float>(par, s32[n], S32) : 0.f;
      float left = __shfl_up_sync(kFull, g, 1);
      if (lane == 0) left = carry;
      carry = __shfl_sync(kFull, g, 31);
      const bool flip = n >= 1 && n < N && sign_of(left) * sign_of(g) < 0;
      const unsigned ballot = __ballot_sync(kFull, flip);
      if (flip) {
        const int rank = count + __popc(ballot & ((1u << lane) - 1u));
        if (rank < kMaxC) {
          slot_n[w][rank] = n - 1;
          slot_g[w][rank] = left;
        }
      }
      count += __popc(ballot);
    }
    __syncwarp();
    const int n_roots = count < kMaxC ? count : kMaxC;
    T s_root = T(0);
    bool keep = false;
    int idx = -1;
    if (lane < n_roots) {
      idx = slot_n[w][lane];
      T p[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) p[k] = parT[(size_t)b * 10 + k];
      T lo = sT[idx], hi = sT[idx + 1];
      T g_lo = T(slot_g[w][lane]);
      for (int it = 0; it < bisect; ++it) {
        const T mid = T(0.5) * (lo + hi);
        const T g_mid = art::line_point_condition<T>(p, mid, ST);
        if (sign_of(g_mid) == sign_of(g_lo)) {
          lo = mid;
          g_lo = g_mid;
        } else {
          hi = mid;
        }
      }
      s_root = T(0.5) * (lo + hi);
      keep = art::line_accept<T>(p[0] + s_root * p[3], p[1] + s_root * p[4],
                                 p[2] + s_root * p[5], p[9], ST);
    }
    __syncwarp();   // the slots are read before the warp's next line writes them
    if (lane < kMaxC) {
      const size_t o = (size_t)b * kMaxC + lane;
      s_star[o] = s_root;
      ok[o] = keep ? 1 : 0;
      if (slot_idx) slot_idx[o] = idx;
    }
    if (lane == 0) n_flips[b] = count;
  }
}

template <typename T>
int launch_roots(const float* par32, const float* s32, const T* parT, const T* sT, int B, int N,
                 int bisect, const art::LineScene& S32, const art::LineSceneT<T>& ST,
                 T* s_star, uint8_t* ok, int* n_flips, int* slot_idx, cudaStream_t stream) {
  const int blocks = (B + kRootWarps - 1) / kRootWarps;
  line_roots_kernel<T><<<blocks < 65535 ? blocks : 65535, kRootWarps * 32, 0, stream>>>(
      par32, s32, parT, sT, B, N, bisect, S32, ST, s_star, ok, n_flips, slot_idx);
  return (int)cudaGetLastError();
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

// The fused kernel.  par32 [B, 10] and s32 [N] f32 (the scan); parT [B, 10]
// and sT [N] in T = double if dbl else float (the bisection and the filter;
// for float the same tensors as par32 and s32); outputs s_star [B, 16] in
// T, ok [B, 16] uint8, n_flips [B] int32, slot_idx [B, 16] int32 or null.
// S32 is the scan's scene, S64 the bisection's when dbl.  All contiguous, on
// the device; N >= 2.  Launches on `stream`; returns cudaGetLastError().
extern "C" int art_line_roots(int dbl, const float* par32, const float* s32, const void* parT,
                              const void* sT, int B, int N, int bisect, art::LineScene S32,
                              art::LineScene64 S64, void* s_star, uint8_t* ok, int* n_flips,
                              int* slot_idx, void* stream) {
  if (B <= 0) return 0;
  if (N < 2 || bisect < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dbl)
    return launch_roots<double>(par32, s32, (const double*)parT, (const double*)sT, B, N, bisect,
                                S32, S64, (double*)s_star, ok, n_flips, slot_idx, st);
  return launch_roots<float>(par32, s32, (const float*)parT, (const float*)sT, B, N, bisect, S32,
                             S32, (float*)s_star, ok, n_flips, slot_idx, st);
}
