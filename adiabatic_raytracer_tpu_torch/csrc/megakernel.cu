// K2: the whole adaptive Dormand-Prince 5(4) integrator in one kernel, f64.
//
// Replaces the Pallas TPU megakernel adiabatic_raytracer_tpu/ops/megakernel.py
// _mega_kernel (via integrate_mega): per ray, the adaptive DP5 loop in log
// time with the I/PI step controller, the hand-adjoint nondimensionalized RHS
// (_grad_h_hand, _rhs), the gated event scan on the cubic-Hermite
// interpolant, bisection, start-point and r < 1.01 r_NS rejection, NS kill,
// stall cut, up to max_crossings crossing records, the ntimes=3 midpoint and
// the conversion probability (_prob_nd) at each recorded crossing.
//
// What bounds it on the card: f64 arithmetic and divergence.  A step costs
// ~6 RHS (~250 flops each, ~30 of them div/sqrt/sincos) plus 3-49 condition
// evaluations; the data moved is a few hundred bytes per ray for the whole
// integration.  Step counts per ray are heavy-tailed, so a warp runs until
// its slowest ray finishes, and rays of one warp take different branches of
// the event scan.
// What the design does about it: one thread per ray, a `while` loop per
// thread, state in registers (spilling to L1-resident local memory), no
// shared memory and no inter-thread traffic; crossing records, the midpoint
// and pcx go straight to global memory; the dense 50-point scan runs only on
// the threads whose own coarse pass asks for it (per-thread gate).
// Precision: the TPU kernel's float-float state, Cody-Waite sin/cos/exp and
// f32 bisection cap were workarounds for a chip without f64; here state and
// physics are f64 and libdevice's sin/cos/exp are used.
//
// Event semantics are the pool engine's (ops/integrator.py, this kernel's
// plain version): on each accepted step the Hermite interpolant is scanned at
// `interp` points and up to `max_roots` sign changes are bisected, in order.
// The device functions and the step itself (art::dp5_step) live in
// mega_device.cuh, which the K3 tree kernel (treekernel.cu) shares.
#include "mega_device.cuh"

using art::MegaParams;
using art::Metric;

namespace {

using namespace art;

constexpr int kThreads = 128;
constexpr int kMaxSlots = 16;

__global__ void __launch_bounds__(kThreads)
    mega_kernel(const double* __restrict__ u_in, const double* __restrict__ aux, int B,
                MegaParams P, double* __restrict__ uf, double* __restrict__ lntf,
                double* __restrict__ diag, double* __restrict__ cru,
                double* __restrict__ crlnt, double* __restrict__ save_out,
                double* __restrict__ pcx) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const int S = P.max_crossings;
  Ray R;
  for (int c = 0; c < 7; ++c) R.u[c] = u_in[(size_t)i * 7 + c];
  const double* a = aux + (size_t)i * 8;
  const double lnt0 = a[0], lnt1 = a[1], erg = a[2];
  const double x0c[3] = {a[3], a[4], a[5]};
  const bool photon = a[6] > 0.5;
  for (int s = 0; s < S; ++s) {
    for (int c = 0; c < 7; ++c) cru[((size_t)i * S + s) * 7 + c] = 0.0;
    crlnt[(size_t)i * S + s] = 0.0;
    pcx[(size_t)i * S + s] = 0.0;
  }

  R.lnt = lnt0;
  rhs(P, R.u, R.lnt, erg, photon, R.f0);
  R.g0 = condition(P, R.u, R.lnt);
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
    for (int c = 0; c < 7; ++c) cru[slot * 7 + c] = us[c];
    crlnt[slot] = lnt_s;
    if (P.with_prob) pcx[slot] = prob_nd(P, us, erg);
  };
  while (!done) {
    code = dp5_step(P, R, lnt1, erg, photon, x0c, lnt_mid, save_mid, record);
    done = code != 0;
  }

  for (int c = 0; c < 7; ++c) {
    uf[(size_t)i * 7 + c] = R.u[c];
    save_out[(size_t)i * 7 + c] = lnt_mid <= R.lnt ? save_mid[c] : 0.0;
  }
  lntf[i] = R.lnt;
  diag[(size_t)i * 4 + 0] = R.steps;
  diag[(size_t)i * 4 + 1] = code;
  diag[(size_t)i * 4 + 2] = R.n_cross;
  diag[(size_t)i * 4 + 3] = R.nfine;
}

// One device function at a time on [B] states (for the card-side checks of
// the torch twins): which = 0 metric, 1 dipole, 2 omega_p, 3 condition,
// 4 rhs, 5 prob, 6 hermite (u rows then hold u0, u1, f0, f1, h, tau).
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
      out[i] = art::condition(P, x, lnt[i]);
      break;
    case 4:
      rhs(P, x, lnt[i], erg[i], is_ph[i] > 0.5, out + (size_t)i * 7);
      break;
    case 5:
      out[i] = prob_nd(P, x, erg[i]);
      break;
    case 6:
      hermite(x, x + 7, x + 14, x + 21, x[28], x[29], out + (size_t)i * 7);
      break;
  }
}

}  // namespace

// u_in [B, 7], aux [B, 8] (lnt0, lnt1, erg, x0(3), is_photon, pad); outputs
// uf [B, 7], lntf [B], diag [B, 4] (steps, code, n_cross, n_dense_scans),
// cru [B, S, 7], crlnt [B, S], save_mid [B, 7], pcx [B, S]; all f64,
// contiguous, on the device, S = P.max_crossings <= 16.  Returns
// cudaGetLastError().
extern "C" int art_megakernel(const double* u_in, const double* aux, int B, MegaParams P,
                              double* uf, double* lntf, double* diag, double* cru,
                              double* crlnt, double* save_mid, double* pcx, void* stream) {
  if (B <= 0) return 0;
  if (P.max_crossings < 1 || P.max_crossings > kMaxSlots) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  mega_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(u_in, aux, B, P, uf, lntf, diag,
                                                             cru, crlnt, save_mid, pcx);
  return (int)cudaGetLastError();
}

extern "C" int art_probe(int which, const double* u, const double* lnt, const double* erg,
                         const double* is_ph, double* out, int B, double b0_abs, MegaParams P,
                         void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(which, u, lnt, erg, is_ph, out,
                                                              B, b0_abs, P);
  return (int)cudaGetLastError();
}
