// K2: the whole adaptive Dormand-Prince 5(4) integrator in one kernel, f64,
// one warp per ray.
//
// Replaces the Pallas TPU megakernel adiabatic_raytracer_tpu/ops/megakernel.py
// _mega_kernel (via integrate_mega): per ray, the adaptive DP5 loop in log
// time with the I/PI step controller, the hand-adjoint nondimensionalized RHS
// (_grad_h_hand, _rhs), the gated event scan on the cubic-Hermite
// interpolant, bisection, start-point and r < 1.01 r_NS rejection, NS kill,
// stall cut, up to max_crossings crossing records, the ntimes=3 midpoint and
// the conversion probability (_prob_nd) at each recorded crossing.  The
// dispersion (anisotropic Melrose or isotropic, with or without the
// boundary-layer plasma term; _condition, _grad_h_hand) is a template
// parameter: one instantiation per variant, the launch picks the scene's, so
// the production Melrose instantiation carries no other variant's code.
//
// What bounds it on the card: the latency of one ray's serial chain, not
// bytes or operations.  A step costs 6 RHS (sincos, exp and pow in the
// chain) plus 3-49 condition evaluations and a 60-step bisection per root;
// the data moved is a few hundred bytes per ray for the whole integration.
// Step counts per ray are heavy-tailed, so a launch lasts as long as its
// slowest ray.
// What the design does about it: one warp integrates one ray with the step
// K3 and K4 run (art::dp5_step_warp, tree_warp.cuh): the RHS chain runs
// replicated in the 32 lanes, the event scan (32 points a round) and the
// bisection (5 levels a round) are spread over them, so a recorded root
// costs ~12 condition latencies instead of ~61, and no ray waits for
// another ray's branches (photon and axion rays of a "mixed" launch never
// share a warp).  Warps pull rays from a queue: lane 0's atomicAdd on one
// int head in device memory (zeroed by the caller on the stream), broadcast
// by __shfl_sync, hands out ray indices.  min(B, resident warps) warps are
// launched (art_megakernel asks the occupancy once per device), so a batch
// spreads over every SM and a warp whose ray ended takes the next one
// instead of idling until its block's slowest ray ends.  A ray's result
// depends on nothing but the ray, so the schedule changes no output.  Blocks
// of 4 warps, no shared memory, no barrier.  Stores are spread over the
// lanes: the zeroed crossing slots, each crossing record (lanes 0..6 one
// cru component each, lane 0 crlnt and pcx; prob_nd runs in every lane, so
// the warp never diverges), then uf, save_mid, lntf and diag.
// Precision: the TPU kernel's float-float state, Cody-Waite sin/cos/exp and
// f32 bisection cap were workarounds for a chip without f64; here state and
// physics are f64 and libdevice's sin/cos/exp are used.
//
// Event semantics are the pool engine's (ops/integrator.py, this kernel's
// plain version): on each accepted step the Hermite interpolant is scanned at
// `interp` points and up to `max_roots` sign changes are bisected, in order.
// The device functions live in mega_device.cuh, the step in tree_warp.cuh.
#include "tree_warp.cuh"

using art::MegaParams;
using art::Metric;

namespace {

using namespace art;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSlots = 16;

// v[k] for a lane-dependent k < N, without indexing a register array by a
// runtime value.
template <int N>
__device__ __forceinline__ double pick(const double* v, int k) {
  double x = v[0];
#pragma unroll
  for (int r = 1; r < N; ++r) x = k == r ? v[r] : x;
  return x;
}

// Ray i, integrated by all 32 lanes of the warp (same registers in every
// lane); `lane` is the caller's lane index; V the dispersion variant.
template <int V>
__device__ __forceinline__ void run_ray(const double* __restrict__ u_in,
                                        const double* __restrict__ aux, int i,
                                        const MegaParams& P, double* __restrict__ uf,
                                        double* __restrict__ lntf, double* __restrict__ diag,
                                        double* __restrict__ cru, double* __restrict__ crlnt,
                                        double* __restrict__ save_out,
                                        double* __restrict__ pcx, int lane) {
  const int S = P.max_crossings;
  Ray R;
  for (int c = 0; c < 7; ++c) R.u[c] = u_in[(size_t)i * 7 + c];
  const double* a = aux + (size_t)i * 8;
  const double lnt0 = a[0], lnt1 = a[1], erg = a[2];
  const double x0c[3] = {a[3], a[4], a[5]};
  const bool photon = a[6] > 0.5;
  for (int c = lane; c < S * 7; c += 32) cru[(size_t)i * S * 7 + c] = 0.0;
  for (int s = lane; s < S; s += 32) {
    crlnt[(size_t)i * S + s] = 0.0;
    pcx[(size_t)i * S + s] = 0.0;
  }
  __syncwarp();  // the zeros land before any lane writes a record over them

  R.lnt = lnt0;
  rhs<V>(P, R.u, R.lnt, erg, photon, R.f0);
  R.g0 = condition<V>(P, R.u, R.lnt);
  const double span = lnt1 - lnt0;
  bool done = span <= 0.0;
  R.dt = initial_dt(P, R.u, R.f0, span);
  const double lnt_mid = lnt0 + span * 0.5;
  double save_mid[7] = {0, 0, 0, 0, 0, 0, 0};
  R.steps = 0;
  R.n_cross = 0;
  R.nfine = 0;
  R.nbisect = 0;
  R.lnt_ck = lnt0;
  R.errold = 1e-4;
  int code = 0;
  // every recorded crossing: its state, log time and (with_prob) probability
  auto record = [&](const double* us, double lnt_s, int n) {
    const size_t slot = (size_t)i * S + n;
    const double p = P.with_prob ? prob_nd(P, us, erg) : 0.0;
    if (lane < 7) cru[slot * 7 + lane] = pick<7>(us, lane);
    if (lane == 0) {
      crlnt[slot] = lnt_s;
      if (P.with_prob) pcx[slot] = p;
    }
  };
  while (!done) {
    code = dp5_step_warp<V>(P, R, lnt1, erg, photon, x0c, lnt_mid, save_mid, lane, record);
    done = code != 0;
  }

  // lanes 0..6 uf, 7..13 save_mid, 14 lntf, 15..18 diag
  if (lane < 7) {
    uf[(size_t)i * 7 + lane] = pick<7>(R.u, lane);
  } else if (lane < 14) {
    save_out[(size_t)i * 7 + lane - 7] = lnt_mid <= R.lnt ? pick<7>(save_mid, lane - 7) : 0.0;
  } else if (lane == 14) {
    lntf[i] = R.lnt;
  } else if (lane < 19) {
    const double d[4] = {(double)R.steps, (double)code, (double)R.n_cross, (double)R.nfine};
    diag[(size_t)i * 4 + lane - 15] = pick<4>(d, lane - 15);
  }
}

// Warps w < warps pull rays from *head until B is reached.  One
// instantiation per dispersion variant (physics.cuh Disp).
template <int V>
__global__ void __launch_bounds__(kThreads)
    mega_kernel(const double* __restrict__ u_in, const double* __restrict__ aux, int B,
                int warps, int* __restrict__ head, MegaParams P, double* __restrict__ uf,
                double* __restrict__ lntf, double* __restrict__ diag,
                double* __restrict__ cru, double* __restrict__ crlnt,
                double* __restrict__ save_out, double* __restrict__ pcx) {
  const int lane = threadIdx.x & 31;
  if ((int)(blockIdx.x * kWarps + threadIdx.x / 32) >= warps) return;
  for (;;) {
    int i = 0;
    if (lane == 0) i = atomicAdd(head, 1);
    i = __shfl_sync(kFullMask, i, 0);
    if (i >= B) return;
    run_ray<V>(u_in, aux, i, P, uf, lntf, diag, cru, crlnt, save_out, pcx, lane);
  }
}

// One device function at a time on [B] states (for the card-side checks of
// the torch twins): which = 0 metric, 1 dipole, 2 omega_p, 3 condition,
// 4 rhs, 5 prob, 6 hermite (u rows then hold u0, u1, f0, f1, h, tau); V the
// dispersion variant of condition and rhs.
template <int V>
__global__ void probe_kernel(int which, const double* __restrict__ u,
                             const double* __restrict__ lnt, const double* __restrict__ erg,
                             const double* __restrict__ is_ph, double* __restrict__ out, int B,
                             double b0_abs, MegaParams P) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const int width = which == 6 ? 30 : 7;
  const double* x = u + (size_t)i * width;
  double s_th, c_th, s_ph, c_ph, swt, cwt;
  sincos(x[1], &s_th, &c_th);
  sincos(x[2], &s_ph, &c_ph);
  sincos(P.omega * exp(lnt[i]), &swt, &cwt);
  double br, bth, bph;
  switch (which) {
    case 0: {
      const Metric<double> g = art::metric<double>(x[0], s_th, P.rs0, P.r_metric);
      out[(size_t)i * 4 + 0] = g.tt;
      out[(size_t)i * 4 + 1] = g.rr;
      out[(size_t)i * 4 + 2] = g.thth;
      out[(size_t)i * 4 + 3] = g.pp;
      break;
    }
    case 1:
    case 2:
      art::dipole_unit<double>(P.cm, P.sm, P.b0_sign, P.r_ns, x[0], c_th, s_th, c_ph, s_ph,
                               swt, cwt, &br, &bth, &bph);
      if (which == 1) {
        out[(size_t)i * 3 + 0] = br;
        out[(size_t)i * 3 + 1] = bth;
        out[(size_t)i * 3 + 2] = bph;
      } else {
        const double wp = art::omega_p<double>(P.omega, (br * c_th - bth * s_th) * b0_abs);
        out[i] = x[0] <= P.r_ns ? 0.0 : wp;
      }
      break;
    case 3:
      out[i] = art::condition<V>(P, x, lnt[i]);
      break;
    case 4:
      rhs<V>(P, x, lnt[i], erg[i], is_ph[i] > 0.5, out + (size_t)i * 7);
      break;
    case 5:
      out[i] = prob_nd(P, x, erg[i]);
      break;
    case 6:
      hermite(x, x + 7, x + 14, x + 21, x[28], x[29], out + (size_t)i * 7);
      break;
  }
}

using MegaKernel = void (*)(const double*, const double*, int, int, int*, MegaParams, double*,
                           double*, double*, double*, double*, double*, double*);
// indexed by art::Disp
const MegaKernel kMegaKernels[4] = {mega_kernel<kMelrose>, mega_kernel<kMelroseBndry>,
                                    mega_kernel<kIso>, mega_kernel<kIsoBndry>};
using ProbeKernel = void (*)(int, const double*, const double*, const double*, const double*,
                             double*, int, double, MegaParams);
const ProbeKernel kProbeKernels[4] = {probe_kernel<kMelrose>, probe_kernel<kMelroseBndry>,
                                      probe_kernel<kIso>, probe_kernel<kIsoBndry>};


// The warps the scene's instantiation keeps resident at once on the current
// device: active blocks per SM (occupancy at its registers) x SMs x 4, asked
// once per device and variant.
int resident_warps(const MegaParams& P, int* out) {
  constexpr int kDevices = 64;
  static int cache[kDevices][4] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int v = disp_of(P);
  if (dev < kDevices && cache[dev][v] > 0) {
    *out = cache[dev][v];
    return 0;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kMegaKernels[v], kThreads, 0);
  *out = per_sm * sms * kWarps;
  if (err == cudaSuccess && dev < kDevices) cache[dev][v] = *out;
  return (int)err;
}

}  // namespace

// u_in [B, 7], aux [B, 8] (lnt0, lnt1, erg, x0(3), is_photon, pad); outputs
// uf [B, 7], lntf [B], diag [B, 4] (steps, code, n_cross, n_dense_scans),
// cru [B, S, 7], crlnt [B, S], save_mid [B, 7], pcx [B, S]; all f64,
// contiguous, on the device, S = P.max_crossings <= 16.  head: one int32 in
// device memory, zeroed by the caller on `stream`.  The instantiation is the
// scene's dispersion variant (art::disp_of); min(B, its resident warps)
// warps pull the rays.  Returns cudaGetLastError().
extern "C" int art_megakernel(const double* u_in, const double* aux, int B, MegaParams P,
                              double* uf, double* lntf, double* diag, double* cru,
                              double* crlnt, double* save_mid, double* pcx, int* head,
                              void* stream) {
  if (B <= 0) return 0;
  if (P.max_crossings < 1 || P.max_crossings > kMaxSlots) return (int)cudaErrorInvalidValue;
  int resident = 0;
  const int err = resident_warps(P, &resident);
  if (err != 0) return err;
  const int warps = resident < 1 ? 1 : (resident < B ? resident : B);
  const int blocks = (warps + kWarps - 1) / kWarps;
  kMegaKernels[disp_of(P)]<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      u_in, aux, B, warps, head, P, uf, lntf, diag, cru, crlnt, save_mid, pcx);
  return (int)cudaGetLastError();
}

// The warps art_megakernel launches at most for P's scene (its
// instantiation's resident warps on the current device).
extern "C" int art_megakernel_resident_warps(MegaParams P, int* out) {
  return resident_warps(P, out);
}

extern "C" int art_probe(int which, const double* u, const double* lnt, const double* erg,
                         const double* is_ph, double* out, int B, double b0_abs, MegaParams P,
                         void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  kProbeKernels[disp_of(P)]<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      which, u, lnt, erg, is_ph, out, B, b0_abs, P);
  return (int)cudaGetLastError();
}
