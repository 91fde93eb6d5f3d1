// Device physics shared by the K1 kernels (line_scan.cu: the grid scan in
// f32, the fused roots kernel's bisection in f32 or f64) and the K2
// megakernel (megakernel.cu, f64): Schwarzschild inverse metric with the
// interior branch, the Goldreich-Julian dipole, the plasma frequency and the
// two forms of the level-crossing condition, with the boundary-layer plasma
// term and the isotropic dispersion, and the sampler's recording filter.
//
// Transcribed from the JAX reference (adiabatic_raytracer_tpu/ops/
// megakernel.py _metric/_dipole_unit/_omega_p/_condition and
// ops/pallas_kernels.py _condition_block); each function has a torch twin of
// the same name in ops/megakernel.py or ops/sampler.py that the CPU tests and
// chip_smoke.py hold it against.  Scene scalars arrive as POD structs passed
// by value at launch, so a new scene needs no rebuild.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// The branches of K2 (and, where they share the step, K3 and K4) that a
// variant library compiles in (ops/cuda_lib.py builds one at the first
// launch of a non-default combination, with these macros; the default
// library is compiled without any of them, so its code is the code without
// the branches): ART_COND_CANONICAL the canonical condition
// (condition_canonical), ART_GATE_NATIVE the coarse gate's condition samples
// on the card's fast f32 sin/cos/exp, ART_RHS_VJP the RHS by forward-mode
// automatic differentiation of hamiltonian_nd (mega_device.cuh), ART_PROFILE
// K2's bench-only step profiles (1 scan, 2 coarse, 3 rhs; tree_warp.cuh).
#ifndef ART_COND_CANONICAL
#define ART_COND_CANONICAL 0
#endif
#ifndef ART_GATE_NATIVE
#define ART_GATE_NATIVE 0
#endif
#ifndef ART_RHS_VJP
#define ART_RHS_VJP 0
#endif
#ifndef ART_PROFILE
#define ART_PROFILE 0
#endif

namespace art {

constexpr double C_KM = 2.99792e5;            // speed of light [km/s]
constexpr double HBAR = 6.582119e-16;         // [eV s]
constexpr double INV_ALPHA = 137.0;
constexpr double M_E_EV = 5.0e5;
constexpr double GAUSS_TO_EV2 = 1.95e-2;
constexpr double SQRT_4PI_ALPHA = 0.30286190409413793;  // sqrt(4 pi / 137)
constexpr double PI = 3.141592653589793;

// K1 scene scalars in the type T of the arithmetic (ops/line_scan.py
// LineScene for float, LineScene64 for double; same order).  bndry_lyr <= 0:
// no boundary layer; else its pole value [eV], rmax * bndry_lyr and the
// reciprocal of the decay length 0.1 rmax [km].
template <typename T>
struct LineSceneT {
  T cm, sm, omega, b0, r_ns, r_metric, rs0, mass_a;
  int isotropic;
  T bndry_lyr, bndry_pole, bndry_center, bndry_inv_decay;
};
using LineScene = LineSceneT<float>;
using LineScene64 = LineSceneT<double>;

// K2 scene + numerics scalars (ops/megakernel.py MegaParams, same order).
struct MegaParams {
  double cm, sm, omega, b0_sign, r_ns, r_metric, rs0, mass_a, wp2_scale;
  double rs0_full, gm_full, prob_scale, rtol, atol, dt_min;
  double safety, min_fac, max_fac, pi_beta, expo1, gate_theta, stall_min;
  int max_steps, interp, interp_coarse, bisect, stall_window;
  int max_roots, max_crossings, species, with_prob;
  double bndry_lyr, bndry_pole_t, bndry_rmax;
  int isotropic;
};

// The dispersion variants of the f64 device code, a template parameter, so
// that each instantiation holds only its own branches: the anisotropic
// Melrose form (the production scene; K3 and K4 run only this one) or the
// isotropic one, each with or without the boundary-layer plasma term.
enum Disp : int { kMelrose = 0, kMelroseBndry = 1, kIso = 2, kIsoBndry = 3 };
__host__ __device__ constexpr bool disp_iso(int v) { return v >= kIso; }
__host__ __device__ constexpr bool disp_bndry(int v) { return (v & 1) != 0; }
// The variant a scene needs, picked at launch.
inline int disp_of(const MegaParams& P) {
  return (P.isotropic ? kIso : kMelrose) + (P.bndry_lyr > 0.0 ? 1 : 0);
}

template <typename T>
struct Metric {
  T tt, rr, thth, pp;
};

template <typename T> __device__ __forceinline__ T dsqrt(T x);
template <> __device__ __forceinline__ float dsqrt<float>(float x) { return sqrtf(x); }
template <> __device__ __forceinline__ double dsqrt<double>(double x) { return sqrt(x); }
template <typename T> __device__ __forceinline__ T dmax(T a, T b);
template <> __device__ __forceinline__ float dmax<float>(float a, float b) { return fmaxf(a, b); }
template <> __device__ __forceinline__ double dmax<double>(double a, double b) { return fmax(a, b); }

// Inverse Schwarzschild metric (g^tt, g^rr, g^thth, g^pp) with the
// reference's interior continuation below rn (models/metric.py).
template <typename T>
__device__ __forceinline__ Metric<T> metric(T r, T sin_th, T rs0, T rn) {
  const bool inside = r <= rn;
  const T q = r / rn;
  const T rs = inside ? rs0 * (q * q * q) : rs0;
  Metric<T> g;
  if (inside) {
    T a1 = T(1) - rs / rn;
    a1 = a1 > T(1e-30) ? a1 : T(1e-30);
    const T a2 = T(1) - r * r * rs / (rn * rn * rn);
    const T a2c = a2 > T(1e-30) ? a2 : T(1e-30);
    const T d = T(3) * dsqrt(a1) - dsqrt(a2c);
    g.tt = T(-4) / (d * d);
    g.rr = a2;
  } else {
    const T one_m = T(1) - rs / r;
    g.tt = T(-1) / one_m;
    g.rr = one_m;
  }
  g.thth = T(1) / (r * r);
  const T rsn = r * sin_th;
  g.pp = T(1) / (rsn * rsn);
  return g;
}

// Goldreich-Julian dipole in units of |b0| (sign in b0_sign), rotated by
// omega*time through cos/sin(phi - omega t) by angle addition.
template <typename T>
__device__ __forceinline__ void dipole_unit(T cm, T sm, T b0_sign, T r_ns, T r, T cz,
                                            T sin_th, T cphi, T sphi, T swt, T cwt,
                                            T* br, T* bth, T* bph) {
  const T cp = cphi * cwt + sphi * swt;
  const T sp = sphi * cwt - cphi * swt;
  const T q = r_ns / r;
  const T bnorm = b0_sign * (q * q * q) * T(0.5);
  *br = T(2) * bnorm * (cm * cz + sm * sin_th * cp);
  *bth = bnorm * (cm * sin_th - sm * cz * cp);
  *bph = bnorm * sm * sp;
}

// Plasma frequency [eV] from the physical B_z [Gauss] (RayTracer.jl:877-878).
template <typename T>
__device__ __forceinline__ T omega_p(T omega, T bz) {
  const T nelec = fabs(T(2) * omega * bz) / T(SQRT_4PI_ALPHA) * T(GAUSS_TO_EV2) * T(HBAR);
  return dsqrt(T(4) * T(PI) * nelec / T(INV_ALPHA) / T(M_E_EV));
}

// The condition's sin/cos and exp: libdevice's f64 functions, or, for the
// coarse gate's samples of a variant library built with ART_GATE_NATIVE
// (Gate true), the card's fast f32 intrinsics on the f32-cast argument (the
// reference's gate_trig "native", megakernel.py:118-145 there: its
// gate-precision sincos and exp, here the card's own).
template <bool Gate>
__device__ __forceinline__ void cond_sincos(double x, double* s, double* c) {
  if constexpr (Gate && ART_GATE_NATIVE) {
    float sf, cf;
    __sincosf((float)x, &sf, &cf);
    *s = sf;
    *c = cf;
  } else {
    sincos(x, s, c);
  }
}
template <bool Gate>
__device__ __forceinline__ double cond_exp(double x) {
  if constexpr (Gate && ART_GATE_NATIVE) return (double)__expf((float)x);
  else return exp(x);
}

// K2's boundary-layer plasma addition to omega_p in mass_a units, before
// its support r > r_ns is applied (models/magnetosphere._bndry_lyr_term,
// RayTracer.jl:1155-1162): pole_t (r_ns / r)^1.5 exp(-(r - rmax lyr) /
// (0.1 rmax)), pole_t = omega_p at the pole / mass_a, rmax the aligned
// dipole's conversion radius; Gate: a coarse gate sample (cond_exp).
template <bool Gate = false>
__device__ __forceinline__ double bndry_term(double r, double r_ns, double pole_t, double rmax,
                                             double lyr) {
  const double q = r_ns / r;
  return pole_t * (q * sqrt(q)) * cond_exp<Gate>(-(r - rmax * lyr) / (0.1 * rmax));
}

// K1: the dipole (b0 times the unit field: *br, *bth, *bph [Gauss]) and
// omega_p [eV] at a Cartesian point of a sampling line with radius rr, cos
// theta cz and sin theta st, t = 0 (the azimuthal trig from Cartesian
// ratios), with the boundary layer where the scene has one and rr >= r_ns
// (models/magnetosphere.omega_p_cart; the Cartesian evaluator never zeroes
// the interior).  T = float keeps the plain version's f32 operations and
// order in the boundary-layer term.
template <typename T>
__device__ __forceinline__ T line_omega_p(T px, T py, T rr, T cz, T st,
                                          const LineSceneT<T>& S, T* br, T* bth, T* bph) {
  dipole_unit<T>(S.cm, S.sm, T(1), S.r_ns, rr, cz, st, px / (rr * st), py / (rr * st), T(0),
                 T(1), br, bth, bph);
  *br *= S.b0;
  *bth *= S.b0;
  *bph *= S.b0;
  T wp = omega_p<T>(S.omega, *br * cz - *bth * st);
  if (S.bndry_lyr > T(0) && rr >= S.r_ns) {
    if constexpr (sizeof(T) == sizeof(float)) {
      // the boundary layer [eV] in the plain version's f32 operations and
      // order (torch: r_ns / r as (1 / r) * r_ns, a division by a scalar as
      // a product with its reciprocal), none fused into the sum
      const float q = __fmul_rn(1.f / rr, S.r_ns);
      const float decay = expf(__fmul_rn(-(rr - S.bndry_center), S.bndry_inv_decay));
      wp = __fadd_rn(wp, __fmul_rn(__fmul_rn(S.bndry_pole, powf(q, 1.5f)), decay));
    } else {
      const T q = S.r_ns / rr;
      wp += S.bndry_pole * pow(q, T(1.5)) * exp(-(rr - S.bndry_center) * S.bndry_inv_decay);
    }
  }
  return wp;
}

// K1: sin(theta) at a Cartesian point of radius rr and cos(theta) cz.  In
// f32, within ~0.6 degrees of a pole (1 - cz^2 < 1e-4), the difference
// 1 - cz^2 keeps few digits (its relative error is ~6e-8 / (1 - cz^2)) and
// the azimuthal ratios px / (rr st), py / (rr st) inherit it: there the
// <float> instantiation takes sin(theta) from the cylindrical radius.  The
// <double> instantiation, and everywhere else the <float> one, take it from
// cz as the plain version (sampler._line_condition) does, so near the poles
// the f32 kernel departs from its f32 plain version, towards the f64 value.
template <typename T>
__device__ __forceinline__ T line_sin_theta(T px, T py, T rr, T cz) {
  const T s2 = T(1) - cz * cz;
  if constexpr (sizeof(T) == sizeof(float)) {
    if (s2 < T(1e-4)) return dmax(dsqrt(px * px + py * py) / rr, T(1e-15));
  }
  return dsqrt(dmax(s2, T(1e-30)));
}

// K1: thick-surface condition at a Cartesian point of a sampling line, the
// momentum renormalized onto the axion shell along the local-velocity
// direction (sampler._line_condition; pallas_kernels._condition_block).
template <typename T>
__device__ __forceinline__ T line_condition(T px, T py, T pz, T vlx, T vly, T vlz, T erg,
                                            const LineSceneT<T>& S) {
  const T rr = dsqrt(px * px + py * py + pz * pz);
  const T cz = pz / rr;
  const T st = line_sin_theta<T>(px, py, rr, cz);
  const T aa = rr < S.r_ns ? T(1) : T(1) - S.rs0 / rr;
  const T dr_dt = (px * vlx + py * vly + pz * vlz) / rr;
  const T v_th = (pz * dr_dt - rr * vlz) / (rr * st);
  const T v_ph = (-py * vlx + px * vly) / (rr * st);
  T w_r = dr_dt / dsqrt(aa) / aa;
  T w_t = v_th * rr / aa;
  T w_p = v_ph * (rr * st) / aa;
  const Metric<T> g = metric<T>(rr, st, S.rs0, S.r_metric);
  const T wsq = g.rr * w_r * w_r + g.thth * w_t * w_t + g.pp * w_p * w_p;
  const T nrm = dsqrt((-(erg * erg) * g.tt - S.mass_a * S.mass_a) / wsq);
  w_r *= nrm;
  w_t *= nrm;
  w_p *= nrm;
  T br, bth, bph;
  const T wp = line_omega_p<T>(px, py, rr, cz, st, S, &br, &bth, &bph);
  T kp = T(0);
  if (!S.isotropic) {
    const T bl_r = br / dsqrt(g.rr), bl_t = bth / dsqrt(g.thth), bl_p = bph / dsqrt(g.pp);
    const T bmag = dsqrt(g.rr * bl_r * bl_r + g.thth * bl_t * bl_t + g.pp * bl_p * bl_p);
    kp = (g.rr * w_r * bl_r + g.thth * w_t * bl_t + g.pp * w_p * bl_p) / bmag;
  }
  const T e2n = erg * erg;
  const T ksqr = g.tt * e2n + g.rr * w_r * w_r + g.thth * w_t * w_t + g.pp * w_p * w_p;
  const T e2 = e2n / g.rr;
  return T(0.5) * (ksqr + wp * wp * (e2 - kp * kp) / e2) / e2n;
}

// K1: the condition at s along the line par = (x0[3], vvec[3], vloc[3],
// erg), at the point x0 + s * vvec.  The grid kernel and the fused roots
// kernel both scan through this one function, so their f32 scans agree bit
// for bit (same source, same contraction into FMAs).
template <typename T>
__device__ __forceinline__ T line_point_condition(const T* par, T s, const LineSceneT<T>& S) {
  return line_condition<T>(par[0] + s * par[3], par[1] + s * par[4], par[2] + s * par[5],
                           par[6], par[7], par[8], par[9], S);
}

// K1: the sampler's recording filter at a root p (affect!,
// RayTracer.jl:1585-1597; sampler._accept_crossing): outside the star and
// locally propagating, erg / sqrt(g^rr) > omega_p.
template <typename T>
__device__ __forceinline__ bool line_accept(T px, T py, T pz, T erg, const LineSceneT<T>& S) {
  const T rr = dsqrt(px * px + py * py + pz * pz);
  const T cz = pz / rr;
  const T st = line_sin_theta<T>(px, py, rr, cz);
  const Metric<T> g = metric<T>(rr, st, S.rs0, S.r_metric);
  T br, bth, bph;
  const T wp = line_omega_p<T>(px, py, rr, cz, st, S, &br, &bth, &bph);
  return rr > S.r_ns && erg / dsqrt(g.rr) > wp;
}

#if ART_COND_CANONICAL
// K2: the canonical crossing condition (the reference's cond_mode
// "canonical", _condition_canonical at megakernel.py:398 there; the literal
// transcription of the pool's crossing_condition): the momenta renormalized
// onto the axion shell, then the Melrose photon Hamiltonian over e7^2,
// 0.5 (ksqr + wp^2 (e2 - kp^2) / e2) / e7^2.  B enters kp only through its
// direction and wp through (wp / ma)^2 = wp2_scale |b_z| on the unit dipole,
// so the unit dipole carries both (|b0| cancels in kp; wp = ma sqrt(wp2t),
// plus ma bt with the boundary layer).  The oracle of the fast form: equal
// up to rounding away from its roots.
template <int V = kMelrose>
__device__ __forceinline__ double condition_canonical(const MegaParams& P, const double* u,
                                                      double lnt) {
  const double t = exp(lnt);
  const double r = u[0];
  double s_th, c_th, s_ph, c_ph, swt, cwt;
  sincos(u[1], &s_th, &c_th);
  const Metric<double> g = metric<double>(r, s_th, P.rs0, P.r_metric);
  const double e72 = u[6] * u[6];
  const double wsq = g.rr * u[3] * u[3] + g.thth * u[4] * u[4] + g.pp * u[5] * u[5];
  const double nrm = sqrt((-e72 * g.tt - P.mass_a * P.mass_a) / wsq);
  const double ww1 = u[3] * nrm, ww2 = u[4] * nrm, ww3 = u[5] * nrm;
  sincos(u[2], &s_ph, &c_ph);
  sincos(P.omega * t, &swt, &cwt);
  double br, bth, bph;
  dipole_unit<double>(P.cm, P.sm, P.b0_sign, P.r_ns, r, c_th, s_th, c_ph, s_ph, swt, cwt,
                      &br, &bth, &bph);
  const double bz = br * c_th - bth * s_th;
  double wp = r <= P.r_ns ? 0.0 : P.mass_a * sqrt(P.wp2_scale * fabs(bz));
  if constexpr (disp_bndry(V)) {
    if (r > P.r_ns)
      wp += P.mass_a * bndry_term(r, P.r_ns, P.bndry_pole_t, P.bndry_rmax, P.bndry_lyr);
  }
  double kp = 0.0;
  if constexpr (!disp_iso(V)) {
    const double bl_r = br / sqrt(g.rr), bl_t = bth / sqrt(g.thth), bl_p = bph / sqrt(g.pp);
    const double bmag = sqrt(g.rr * bl_r * bl_r + g.thth * bl_t * bl_t + g.pp * bl_p * bl_p);
    kp = (g.rr * ww1 * bl_r + g.thth * ww2 * bl_t + g.pp * ww3 * bl_p) / bmag;
  }
  const double ksqr = g.tt * e72 + g.rr * ww1 * ww1 + g.thth * ww2 * ww2 + g.pp * ww3 * ww3;
  const double e2 = e72 / g.rr;
  return 0.5 * (ksqr + wp * wp * (e2 - kp * kp) / e2) / e72;
}
#endif

// K2: strength-reduced crossing condition on the integration state
// u = (r, theta, phi, w_r, w_th, w_ph, e7) at log-time lnt (the reference's
// cond_mode "fast"): 0.5 ma^2 (wp2t mel - 1) / e7^2 with mel = 1 - kp^2/e2
// (Melrose) or 1 (isotropic), and wp2t = (sqrt(wp2t) + bt)^2 with the
// boundary layer.  Gate: a coarse gate sample (cond_sincos, cond_exp).  A
// library built with ART_COND_CANONICAL evaluates condition_canonical
// instead, the gate's samples too, as the reference does.
template <int V = kMelrose, bool Gate = false>
__device__ __forceinline__ double condition(const MegaParams& P, const double* u, double lnt) {
#if ART_COND_CANONICAL
  return condition_canonical<V>(P, u, lnt);
#else
  const double t = cond_exp<Gate>(lnt);
  const double r = u[0];
  double s_th, c_th, s_ph, c_ph, swt, cwt;
  cond_sincos<Gate>(u[1], &s_th, &c_th);
  cond_sincos<Gate>(u[2], &s_ph, &c_ph);
  cond_sincos<Gate>(P.omega * t, &swt, &cwt);
  const Metric<double> g = metric<double>(r, s_th, P.rs0, P.r_metric);
  double br, bth, bph;
  dipole_unit<double>(P.cm, P.sm, P.b0_sign, P.r_ns, r, c_th, s_th, c_ph, s_ph, swt, cwt,
                      &br, &bth, &bph);
  const double bz = br * c_th - bth * s_th;
  double wp2t = r <= P.r_ns ? 0.0 : P.wp2_scale * fabs(bz);
  if constexpr (disp_bndry(V)) {
    const double bt =
        r > P.r_ns ? bndry_term<Gate>(r, P.r_ns, P.bndry_pole_t, P.bndry_rmax, P.bndry_lyr)
                   : 0.0;
    const double wpt = sqrt(wp2t) + bt;
    wp2t = wpt * wpt;
  }
  const double e72 = u[6] * u[6];
  const double inv_e72 = 1.0 / e72;
  double mel = 1.0;
  if constexpr (!disp_iso(V)) {
    const double wsq = g.rr * u[3] * u[3] + g.thth * u[4] * u[4] + g.pp * u[5] * u[5];
    const double nrm2 = (-e72 * g.tt - P.mass_a * P.mass_a) / wsq;
    const double inv_r = 1.0 / r;
    const double n_w =
        sqrt(g.rr) * u[3] * br + inv_r * u[4] * bth + inv_r / fabs(s_th) * u[5] * bph;
    const double bm2 = br * br + bth * bth + bph * bph;
    mel = 1.0 - nrm2 * n_w * n_w * g.rr * inv_e72 / bm2;
  }
  return (0.5 * P.mass_a * P.mass_a) * (wp2t * mel - 1.0) * inv_e72;
#endif
}

}  // namespace art
