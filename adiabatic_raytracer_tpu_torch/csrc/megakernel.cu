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
// The in-kernel MC chain (_mega_kernel's with_chain: a pure-MC tree chain
// continued through its crossings) is one more instantiation,
// mega_chain_kernel, on the Melrose scene only (run_ray's Chain flag), so
// mega_kernel's instantiations carry none of it.
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
//
// The resumable instantiation (the reference's it_cap / resume /
// return_resume, megakernel.py:1436-1490 there, for integrate_mega_chunked)
// is mega_resume_kernel: a launch runs each ray at most it_cap steps, from
// the state a previous launch left (res rows: the FSAL derivative, the
// controller's dt and memory, g0, the stall reference, the absolute step,
// crossing and dense-pass counts, the original save-grid midpoint, done),
// writes only the crossing slots it records, and leaves the state for the
// next launch.  Everything a step reads is carried, so a chunked run is
// bitwise one launch.  It and the mode branches (physics.cuh) are compiled
// only into variant libraries (ops/cuda_lib.py): such a library is built
// with ART_DISP, the one dispersion variant it holds, ART_RESUME, and the
// mode macros; the default library holds every dispersion and none of them.
#include "tree_warp.cuh"

#ifndef ART_RESUME
#define ART_RESUME 0
#endif
#ifdef ART_DISP
#define ART_HAS_DISP(v) ((v) == ART_DISP)
#define ART_HAS_CHAIN (ART_DISP == 0 && ART_PROFILE == 0 && !ART_RESUME)
#else
#define ART_HAS_DISP(v) true
#define ART_HAS_CHAIN 1
#endif

using art::MegaParams;
using art::Metric;

namespace {

using namespace art;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSlots = 16;
// The resume rows of a ray (ops/megakernel.py RES_ROWS names them): the FSAL
// derivative f0 (7), then these.
enum ResRow : int {
  kResDt = 7, kResG0, kResErrold, kResLntCk, kResSteps, kResNCross, kResNFine, kResLntMid,
  kResDone, kResRows
};

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
//
// Chain (mega_chain_kernel): aux column 7 holds the ray's chain cap c.  A
// ray with c > 0 is a pure-MC chain of tree nodes (the reference's
// with_chain, megakernel.py:885-893 there): each segment stops at its first
// recorded crossing; while the crossing is not rare (rare_velocity) and
// fewer than c crossings are recorded, the child is born in the kernel as
// K3 and K4 give birth (child_birth: the draw uni[i, slot] < p at the
// crossing, slot its crossing index, the species flipped if it converts, the
// momenta renormalized in place) and a fresh segment starts at the crossing:
// f0 and g0 there, a fresh initial step, the controller memory and the step
// and stall counters reset, the crossing point as the start point of the
// start-point rejection, as the host engine starts every node.  A chain ends
// where the ray exits, at a rare crossing, or when c crossings are
// recorded.  A ray with c = 0 runs the multi-crossing semantics of the
// other instantiations.  chain_out gets the in-kernel restarts and the
// final species; diag's steps count every segment's.
//
// Resume (mega_resume_kernel): res_in [B, kResRows] is the ray's state
// (resume rows, see kResRows); a ray with done set returns at once, leaving
// its outputs unwritten; a ray with dt 0 starts fresh, as in mega_kernel;
// any other continues from its rows with aux's lnt0 as its current log
// time.  The launch takes at most it_cap steps of the ray, records into the
// slots from its n_cross on without zeroing the others, and writes res_out.
template <int V, bool Chain, bool Resume = false>
__device__ __forceinline__ void run_ray(const double* __restrict__ u_in,
                                        const double* __restrict__ aux,
                                        const double* __restrict__ uni, int i,
                                        const MegaParams& P, double* __restrict__ uf,
                                        double* __restrict__ lntf, double* __restrict__ diag,
                                        double* __restrict__ cru, double* __restrict__ crlnt,
                                        double* __restrict__ save_out,
                                        double* __restrict__ pcx,
                                        double* __restrict__ chain_out, int lane,
                                        const double* __restrict__ res_in = nullptr,
                                        double* __restrict__ res_out = nullptr,
                                        int it_cap = 0) {
  const int S = P.max_crossings;
  Ray R;
  for (int c = 0; c < 7; ++c) R.u[c] = u_in[(size_t)i * 7 + c];
  const double* a = aux + (size_t)i * 8;
  const double lnt0 = a[0], lnt1 = a[1], erg = a[2];
  double x0c[3] = {a[3], a[4], a[5]};
  bool photon = a[6] > 0.5;
  const double* rs = Resume ? res_in + (size_t)i * kResRows : nullptr;
  if constexpr (Resume) {
    if (rs[kResDone] > 0.5) return;
  } else {
    for (int c = lane; c < S * 7; c += 32) cru[(size_t)i * S * 7 + c] = 0.0;
    for (int s = lane; s < S; s += 32) {
      crlnt[(size_t)i * S + s] = 0.0;
      pcx[(size_t)i * S + s] = 0.0;
    }
    __syncwarp();  // the zeros land before any lane writes a record over them
  }

  R.lnt = lnt0;
  bool done;
  double lnt_mid;
  double save_mid[7] = {0, 0, 0, 0, 0, 0, 0};
  if constexpr (Resume) {
    const double span = lnt1 - lnt0;
    done = span <= 0.0;
    R.nbisect = 0;
    if (rs[kResDt] > 0.0) {  // resumed from its rows
      for (int c = 0; c < 7; ++c) R.f0[c] = rs[c];
      R.dt = rs[kResDt];
      R.g0 = rs[kResG0];
      R.errold = rs[kResErrold];
      R.lnt_ck = rs[kResLntCk];
      R.steps = (int)rs[kResSteps];
      R.n_cross = (int)rs[kResNCross];
      R.nfine = (int)rs[kResNFine];
      lnt_mid = rs[kResLntMid];
    } else {  // fresh, as below
      rhs<V>(P, R.u, R.lnt, erg, photon, R.f0);
#if ART_PROFILE == 3
      R.g0 = 0.0;
#else
      R.g0 = condition<V>(P, R.u, R.lnt);
#endif
      R.dt = initial_dt(P, R.u, R.f0, span);
      lnt_mid = lnt0 + span * 0.5;
      R.steps = 0;
      R.n_cross = 0;
      R.nfine = 0;
      R.lnt_ck = lnt0;
      R.errold = 1e-4;
    }
  } else {
    rhs<V>(P, R.u, R.lnt, erg, photon, R.f0);
#if ART_PROFILE == 3
    R.g0 = 0.0;
#else
    R.g0 = condition<V>(P, R.u, R.lnt);
#endif
    const double span = lnt1 - lnt0;
    done = span <= 0.0;
    R.dt = initial_dt(P, R.u, R.f0, span);
    lnt_mid = lnt0 + span * 0.5;
    R.steps = 0;
    R.n_cross = 0;
    R.nfine = 0;
    R.nbisect = 0;
    R.lnt_ck = lnt0;
    R.errold = 1e-4;
  }
  int code = 0;
  int it = 0;
  // the chain's cap and counters, and the last recorded crossing
  int cap = 0, nodes = 0, steps_done = 0;
  double ustar[7], p_star = 0.0;
  if constexpr (Chain) {
    const int c = (int)(a[7] + 0.5);
    cap = c < S ? c : S;
    R.seg0 = 0;
    R.stop_n = cap > 0 ? 1 : S;
  }
  // every recorded crossing: its state, log time and (with_prob) probability
  auto record = [&](const double* us, double lnt_s, int n) {
    const size_t slot = (size_t)i * S + n;
    const double p = P.with_prob ? prob_nd(P, us, erg) : 0.0;
    if (lane < 7) cru[slot * 7 + lane] = pick<7>(us, lane);
    if (lane == 0) {
      crlnt[slot] = lnt_s;
      if (P.with_prob) pcx[slot] = p;
    }
    if constexpr (Chain) {
      for (int c = 0; c < 7; ++c) ustar[c] = us[c];
      p_star = p;
    }
  };
  while (!done) {
    if constexpr (Resume) {
      if (it >= it_cap) break;
      ++it;
    }
    code = dp5_step_warp<V, Chain>(P, R, lnt1, erg, photon, x0c, lnt_mid, save_mid, lane,
                                   record);
    if constexpr (Chain) {
      // a chain segment that stopped at its crossing (R is there): continue
      // through it unless the crossing is rare or the cap is reached
      if (code == 3 && cap > 0 && R.n_cross < cap && !rare_velocity(P, ustar, erg)) {
        double dw_child;
        if (child_birth(P, ustar, erg, uni[(size_t)i * S + R.n_cross - 1], p_star, R.u,
                        &dw_child))
          photon = !photon;
        rhs<V>(P, R.u, R.lnt, erg, photon, R.f0);
        R.g0 = condition<V>(P, R.u, R.lnt);
        R.dt = initial_dt(P, R.u, R.f0, lnt1 - R.lnt);
        steps_done += R.steps;
        R.steps = 0;
        R.lnt_ck = R.lnt;
        R.errold = 1e-4;
        double st, ct, sp, cp;
        sincos(R.u[1], &st, &ct);
        sincos(R.u[2], &sp, &cp);
        x0c[0] = R.u[0] * st * cp;
        x0c[1] = R.u[0] * st * sp;
        x0c[2] = R.u[0] * ct;
        R.seg0 = R.n_cross;
        R.stop_n = R.n_cross + 1;
        nodes += 1;
        code = 0;
        done = lnt1 - R.lnt <= 0.0;  // a node born at lnt1 takes no step
        continue;
      }
    }
    done = code != 0;
  }

  // lanes 0..6 uf, 7..13 save_mid, 14 lntf, 15..18 diag (19, 20 chain_out)
  if (lane < 7) {
    uf[(size_t)i * 7 + lane] = pick<7>(R.u, lane);
  } else if (lane < 14) {
    save_out[(size_t)i * 7 + lane - 7] = lnt_mid <= R.lnt ? pick<7>(save_mid, lane - 7) : 0.0;
  } else if (lane == 14) {
    lntf[i] = R.lnt;
  } else if (lane < 19) {
    const double d[4] = {(double)(R.steps + steps_done), (double)code, (double)R.n_cross,
                         (double)R.nfine};
    diag[(size_t)i * 4 + lane - 15] = pick<4>(d, lane - 15);
  } else if (Chain && lane < 21) {
    chain_out[(size_t)i * 2 + lane - 19] = lane == 19 ? (double)nodes : (photon ? 1.0 : 0.0);
  }
  if constexpr (Resume) {
    const double out[kResRows] = {R.f0[0], R.f0[1], R.f0[2], R.f0[3], R.f0[4], R.f0[5],
                                  R.f0[6], R.dt, R.g0, R.errold, R.lnt_ck, (double)R.steps,
                                  (double)R.n_cross, (double)R.nfine, lnt_mid,
                                  code != 0 ? 1.0 : 0.0};
    if (lane < kResRows) res_out[(size_t)i * kResRows + lane] = pick<kResRows>(out, lane);
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
    run_ray<V, false>(u_in, aux, nullptr, i, P, uf, lntf, diag, cru, crlnt, save_out, pcx,
                      nullptr, lane);
  }
}

#if ART_HAS_CHAIN
// K2's chain instantiation: mega_kernel's ray queue over run_ray<kMelrose,
// true>, with the uniforms [B, S] and chain_out [B, 2] (in-kernel restarts,
// final species).  The in-kernel probability, which the chain draws
// against, covers the Melrose scene without boundary layer only
// (megakernel.can_prob), so that is the one instantiation.
__global__ void __launch_bounds__(kThreads)
    mega_chain_kernel(const double* __restrict__ u_in, const double* __restrict__ aux,
                      const double* __restrict__ uni, int B, int warps, int* __restrict__ head,
                      MegaParams P, double* __restrict__ uf, double* __restrict__ lntf,
                      double* __restrict__ diag, double* __restrict__ cru,
                      double* __restrict__ crlnt, double* __restrict__ save_out,
                      double* __restrict__ pcx, double* __restrict__ chain_out) {
  const int lane = threadIdx.x & 31;
  if ((int)(blockIdx.x * kWarps + threadIdx.x / 32) >= warps) return;
  for (;;) {
    int i = 0;
    if (lane == 0) i = atomicAdd(head, 1);
    i = __shfl_sync(kFullMask, i, 0);
    if (i >= B) return;
    run_ray<kMelrose, true>(u_in, aux, uni, i, P, uf, lntf, diag, cru, crlnt, save_out, pcx,
                            chain_out, lane);
  }
}
#endif

#if ART_RESUME
// K2's resumable instantiation: mega_kernel's ray queue over run_ray<V,
// false, true>, with the resume rows res_in / res_out [B, kResRows] and the
// launch's step cap.
template <int V>
__global__ void __launch_bounds__(kThreads)
    mega_resume_kernel(const double* __restrict__ u_in, const double* __restrict__ aux, int B,
                       int warps, int* __restrict__ head, MegaParams P, double* __restrict__ uf,
                       double* __restrict__ lntf, double* __restrict__ diag,
                       double* __restrict__ cru, double* __restrict__ crlnt,
                       double* __restrict__ save_out, double* __restrict__ pcx,
                       const double* __restrict__ res_in, double* __restrict__ res_out,
                       int it_cap) {
  const int lane = threadIdx.x & 31;
  if ((int)(blockIdx.x * kWarps + threadIdx.x / 32) >= warps) return;
  for (;;) {
    int i = 0;
    if (lane == 0) i = atomicAdd(head, 1);
    i = __shfl_sync(kFullMask, i, 0);
    if (i >= B) return;
    run_ray<V, false, true>(u_in, aux, nullptr, i, P, uf, lntf, diag, cru, crlnt, save_out, pcx,
                            nullptr, lane, res_in, res_out, it_cap);
  }
}
#endif

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
using ProbeKernel = void (*)(int, const double*, const double*, const double*, const double*,
                             double*, int, double, MegaParams);
using ResumeKernel = void (*)(const double*, const double*, int, int, int*, MegaParams,
                              double*, double*, double*, double*, double*, double*, double*,
                              const double*, double*, int);
// The instantiations of dispersion variant V the library holds (nullptr:
// none; a variant library holds one variant, and mega_kernel or the
// resumable kernel, not both).
template <int V>
MegaKernel mega_of() {
  if constexpr (ART_HAS_DISP(V) && !ART_RESUME) return mega_kernel<V>;
  else return nullptr;
}
template <int V>
ProbeKernel probe_of() {
  if constexpr (ART_HAS_DISP(V)) return probe_kernel<V>;
  else return nullptr;
}
template <int V>
ResumeKernel resume_of() {
#if ART_RESUME
  if constexpr (ART_HAS_DISP(V)) return mega_resume_kernel<V>;
#endif
  return nullptr;
}
// indexed by art::Disp
const MegaKernel kMegaKernels[4] = {mega_of<kMelrose>(), mega_of<kMelroseBndry>(),
                                    mega_of<kIso>(), mega_of<kIsoBndry>()};
const ProbeKernel kProbeKernels[4] = {probe_of<kMelrose>(), probe_of<kMelroseBndry>(),
                                      probe_of<kIso>(), probe_of<kIsoBndry>()};
const ResumeKernel kResumeKernels[4] = {resume_of<kMelrose>(), resume_of<kMelroseBndry>(),
                                        resume_of<kIso>(), resume_of<kIsoBndry>()};


// The warps the scene's instantiation (kind 1: the chain instantiation, 2:
// the resumable one) keeps resident at once on the current device: active
// blocks per SM (occupancy at its registers) x SMs x 4, asked once per
// device and instantiation.
int resident_warps(const MegaParams& P, int kind, int* out) {
  constexpr int kDevices = 64;
  static int cache[kDevices][6] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int v = kind == 1 ? 4 : kind == 2 ? 5 : disp_of(P);
  if (dev < kDevices && cache[dev][v] > 0) {
    *out = cache[dev][v];
    return 0;
  }
  const void* fn = kind == 2 ? (const void*)kResumeKernels[disp_of(P)]
                             : (const void*)kMegaKernels[disp_of(P)];
#if ART_HAS_CHAIN
  if (kind == 1) fn = (const void*)mega_chain_kernel;
#endif
  if (fn == nullptr) return (int)cudaErrorInvalidDeviceFunction;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  *out = per_sm * sms * kWarps;
  if (err == cudaSuccess && dev < kDevices) cache[dev][v] = *out;
  return (int)err;
}

int warps_for(const MegaParams& P, int kind, int B, int* warps) {
  int resident = 0;
  const int err = resident_warps(P, kind, &resident);
  *warps = resident < 1 ? 1 : (resident < B ? resident : B);
  return err;
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
  const MegaKernel kernel = kMegaKernels[disp_of(P)];
  if (kernel == nullptr) return (int)cudaErrorInvalidDeviceFunction;
  int warps = 0;
  const int err = warps_for(P, 0, B, &warps);
  if (err != 0) return err;
  const int blocks = (warps + kWarps - 1) / kWarps;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(u_in, aux, B, warps, head, P, uf, lntf,
                                                        diag, cru, crlnt, save_mid, pcx);
  return (int)cudaGetLastError();
}

#if ART_RESUME
// art_megakernel's resumable instantiation (a variant library built with
// ART_RESUME): aux column 0 holds each ray's current log time, res_in /
// res_out [B, kResRows] its resume rows (fresh where dt is 0; done rays are
// skipped and their outputs left unwritten), it_cap the steps a ray may take
// in this launch.  Records go only into the slots recorded in this launch;
// the others are left as the caller allocated them.  Returns
// cudaGetLastError().
extern "C" int art_megakernel_resume(const double* u_in, const double* aux, int B, MegaParams P,
                                     double* uf, double* lntf, double* diag, double* cru,
                                     double* crlnt, double* save_mid, double* pcx,
                                     const double* res_in, double* res_out, int it_cap,
                                     int* head, void* stream) {
  if (B <= 0) return 0;
  if (P.max_crossings < 1 || P.max_crossings > kMaxSlots || it_cap < 1)
    return (int)cudaErrorInvalidValue;
  const ResumeKernel kernel = kResumeKernels[disp_of(P)];
  if (kernel == nullptr) return (int)cudaErrorInvalidDeviceFunction;
  int warps = 0;
  const int err = warps_for(P, 2, B, &warps);
  if (err != 0) return err;
  const int blocks = (warps + kWarps - 1) / kWarps;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(u_in, aux, B, warps, head, P, uf, lntf,
                                                        diag, cru, crlnt, save_mid, pcx, res_in,
                                                        res_out, it_cap);
  return (int)cudaGetLastError();
}
#endif

// art_megakernel's chain instantiation: aux column 7 holds each ray's chain
// cap (0: the multi-crossing semantics; c > 0: the chain, at most S
// crossings), uni [B, S] the uniform of each crossing slot's node, and
// chain_out [B, 2] gets the in-kernel restarts and the final species
// (1 photon).  The scene must be one megakernel.can_prob covers, with
// P.with_prob set.  Returns cudaGetLastError().
#if ART_HAS_CHAIN
extern "C" int art_megakernel_chain(const double* u_in, const double* aux, const double* uni,
                                    int B, MegaParams P, double* uf, double* lntf,
                                    double* diag, double* cru, double* crlnt,
                                    double* save_mid, double* pcx, double* chain_out,
                                    int* head, void* stream) {
  if (B <= 0) return 0;
  if (P.max_crossings < 1 || P.max_crossings > kMaxSlots || disp_of(P) != kMelrose ||
      !P.with_prob)
    return (int)cudaErrorInvalidValue;
  int warps = 0;
  const int err = warps_for(P, 1, B, &warps);
  if (err != 0) return err;
  const int blocks = (warps + kWarps - 1) / kWarps;
  mega_chain_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      u_in, aux, uni, B, warps, head, P, uf, lntf, diag, cru, crlnt, save_mid, pcx, chain_out);
  return (int)cudaGetLastError();
}
#endif

// The warps art_megakernel launches at most for P's scene (its
// instantiation's resident warps on the current device).
extern "C" int art_megakernel_resident_warps(MegaParams P, int* out) {
  return resident_warps(P, ART_RESUME ? 2 : 0, out);
}

extern "C" int art_probe(int which, const double* u, const double* lnt, const double* erg,
                         const double* is_ph, double* out, int B, double b0_abs, MegaParams P,
                         void* stream) {
  if (B <= 0) return 0;
  const ProbeKernel kernel = kProbeKernels[disp_of(P)];
  if (kernel == nullptr) return (int)cudaErrorInvalidDeviceFunction;
  const int blocks = (B + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(which, u, lnt, erg, is_ph, out, B,
                                                        b0_abs, P);
  return (int)cudaGetLastError();
}
