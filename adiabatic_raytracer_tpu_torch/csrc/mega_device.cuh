// f64 device code shared by the three f64 kernels, K2 (megakernel.cu), K3
// (treekernel.cu) and K4 (treerefill.cu): the DP5 tableau, the hand-adjoint
// Hamilton RHS, the in-kernel conversion probability, the cubic-Hermite
// interpolant, the initial step and the state of one integration (`Ray`).
// The step that uses them, with its event scan and bisection, is
// art::dp5_step_warp (tree_warp.cuh), run by one warp per integration.
//
// Transcribed from the JAX reference (adiabatic_raytracer_tpu/ops/
// megakernel.py _grad_h_hand/_rhs/_prob_nd/_hermite and the body of
// _mega_kernel); each function has a torch twin of the same name in
// ops/megakernel.py that the CPU tests and chip_smoke.py hold it against.
// The constants and functions have internal linkage (static or inline), so
// each kernel source compiles its own copy.
#pragma once

#include "physics.cuh"

namespace art {

static __constant__ double kC[7] = {0.0, 1.0 / 5, 3.0 / 10, 4.0 / 5, 8.0 / 9, 1.0, 1.0};
static __constant__ double kA[7][6] = {
    {0, 0, 0, 0, 0, 0},
    {1.0 / 5, 0, 0, 0, 0, 0},
    {3.0 / 40, 9.0 / 40, 0, 0, 0, 0},
    {44.0 / 45, -56.0 / 15, 32.0 / 9, 0, 0, 0},
    {19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729, 0, 0},
    {9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176, -5103.0 / 18656, 0},
    {35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784, 11.0 / 84}};
static __constant__ double kE[7] = {
    35.0 / 384 - 5179.0 / 57600, 0.0 - 0.0, 500.0 / 1113 - 7571.0 / 16695,
    125.0 / 192 - 393.0 / 640,   -2187.0 / 6784 - -92097.0 / 339200,
    11.0 / 84 - 187.0 / 2100,    0.0 - 1.0 / 40};

// d(g^tt, g^rr, g^thth, g^pp)/dr of art::metric, both branches.
static __device__ void dmetric_dr(double r, double sin_th, double rs0, double rn, double d[4]) {
  if (r <= rn) {
    const double rn2 = rn * rn, rn4 = rn2 * rn2, rn6 = rn4 * rn2;
    const double a1 = 1.0 - rs0 * r * r * r / rn4;
    const double a2 = 1.0 - rs0 * r * r * r * r * r / rn6;
    const double s1 = sqrt(a1 > 1e-30 ? a1 : 1e-30);
    const double s2 = sqrt(a2 > 1e-30 ? a2 : 1e-30);
    const double da1 = a1 > 1e-30 ? -3.0 * rs0 * r * r / rn4 : 0.0;
    const double da2 = -5.0 * rs0 * r * r * r * r / rn6;
    const double dd = 3.0 * da1 / (2.0 * s1) - (a2 > 1e-30 ? da2 : 0.0) / (2.0 * s2);
    const double den = 3.0 * s1 - s2;
    d[0] = 8.0 / (den * den * den) * dd;
    d[1] = da2;
  } else {
    const double one_m = 1.0 - rs0 / r;
    d[0] = (rs0 / (r * r)) / (one_m * one_m);
    d[1] = rs0 / (r * r);
  }
  d[2] = -2.0 / (r * r * r);
  d[3] = -2.0 / (r * r * r * sin_th * sin_th);
}

// The photon branch of grad_h_hand at the clamped radius r = max(x1, r_ns):
// on the exterior metric (kIn false: g^rr = A = 1 - rs0/r = -1/g^tt), or on
// the interior branch below r_metric (kIn true: g^rr, dg^rr/dr and dg^tt/dr
// from metric and dmetric_dr), which r reaches when r_ns < r_metric.  The
// derivation is in the torch twin's docstring (ops/megakernel.py
// _grad_h_hand).  One instantiation per branch, so the exterior one is the
// arithmetic the kernels ran before the interior existed.
template <int V, bool kIn>
__device__ __forceinline__ void grad_h_photon(const MegaParams& P, double x1, double r,
                                              double kt1, double kt2, double kt3,
                                              double ergt_ph, double s_th, double c_th,
                                              double s_ph, double c_ph, double swt, double cwt,
                                              double gx[3], double gk[3], double* gt) {
  const double inv_r = 1.0 / r;
  const double inv_s = 1.0 / s_th;
  const double inv_r2 = inv_r * inv_r;
  const double g_pp = inv_r2 * inv_s * inv_s;
  // g^rr, dg^rr/dr and d(ksqr)/dr.  The exterior's d(ksqr)/dr stays the one
  // expression it was before the interior branch existed: split into two
  // statements, its product and difference rounded differently on the card
  // (K2's photon rays and K3's events were no longer bitwise the old ones).
  double G, dG, dksqr_r;
  if constexpr (kIn) {
    const Metric<double> g = metric<double>(r, s_th, P.rs0, P.r_metric);
    double d[4];
    dmetric_dr(r, s_th, P.rs0, P.r_metric, d);
    G = g.rr;
    dG = d[1];
    dksqr_r = ergt_ph * ergt_ph * d[0] + kt1 * kt1 * d[1] -
              2.0 * inv_r2 * inv_r * (kt2 * kt2 + inv_s * inv_s * kt3 * kt3);
  } else {
    const double A = 1.0 - P.rs0 * inv_r;
    const double inv_A = 1.0 / A;
    const double dA_dr = P.rs0 * inv_r2;
    G = A;
    dG = dA_dr;
    dksqr_r = (ergt_ph * ergt_ph * inv_A * inv_A + kt1 * kt1) * dA_dr -
              2.0 * inv_r2 * inv_r * (kt2 * kt2 + inv_s * inv_s * kt3 * kt3);
  }
  const double E = 1.0 / (ergt_ph * ergt_ph);

  const double cp = c_ph * cwt + s_ph * swt;
  const double sp = s_ph * cwt - c_ph * swt;
  const double q = P.r_ns * inv_r;
  const double bnorm = P.b0_sign * 0.5 * (q * q * q);
  const double m_r = P.cm * c_th + P.sm * s_th * cp;
  const double m_t = P.cm * s_th - P.sm * c_th * cp;
  const double br = 2.0 * bnorm * m_r;
  const double bth = bnorm * m_t;
  const double bph = bnorm * P.sm * sp;
  const double bz = br * c_th - bth * s_th;
  const double wp2 = P.wp2_scale * fabs(bz);
  const double sgn = bz > 0.0 ? 1.0 : (bz < 0.0 ? -1.0 : 0.0);
  const double w_fac = P.wp2_scale * sgn;

  const double dinv_s = -inv_s * inv_s * c_th;
  const double dksqr_th = 2.0 * inv_r2 * inv_s * dinv_s * kt3 * kt3;

  double ph_r;
  if constexpr (disp_iso(V)) {
    // H = 0.5 (ksqr + wp2): no anisotropy chain
    const double dbz_r = -3.0 * bz * inv_r;
    const double dbz_th = -3.0 * bth * c_th - 1.5 * br * s_th;
    const double dbz_ph = -3.0 * s_th * c_th * bph;
    const double dbz_t = 3.0 * bnorm * P.sm * s_th * c_th * P.omega * sp;
    ph_r = 0.5 * (dksqr_r + w_fac * dbz_r);
    gx[1] = 0.5 * (dksqr_th + w_fac * dbz_th);
    gx[2] = 0.5 * w_fac * dbz_ph;
    gk[0] = G * kt1;
    gk[1] = inv_r2 * kt2;
    gk[2] = g_pp * kt3;
    *gt = 0.5 * w_fac * dbz_t;
    if constexpr (disp_bndry(V)) {
      const double wpt = sqrt(fmax(wp2, 1e-30));
      const double bt = r > P.r_ns
          ? bndry_term(r, P.r_ns, P.bndry_pole_t, P.bndry_rmax, P.bndry_lyr) : 0.0;
      *gt += 0.5 * (bt / wpt) * w_fac * dbz_t;
    }
  } else {
    const double sqG = sqrt(G);
    const double q1 = sqG * kt1, q2 = inv_r * kt2, q3 = inv_r * inv_s * kt3;
    const double n = q1 * br + q2 * bth + q3 * bph;
    const double bm2 = br * br + bth * bth + bph * bph;
    const double inv_bm2 = 1.0 / bm2;
    const double kp2 = n * n * inv_bm2;
    const double F = 1.0 - kp2 * G * E;
    const double lam = wp2 * G * E * n * inv_bm2;
    gk[0] = G * kt1 - lam * sqG * br;
    gk[1] = inv_r2 * kt2 - lam * inv_r * bth;
    gk[2] = g_pp * kt3 - lam * inv_r * inv_s * bph;
    const double aE = G * E;

    const double dn_r = (0.5 * dG / sqG) * kt1 * br - 3.0 * inv_r * n -
                        inv_r * (q2 * bth + q3 * bph);
    const double dkp2_r = inv_bm2 * 2.0 * n * dn_r + 6.0 * kp2 * inv_r;
    const double dwp2_r = -3.0 * wp2 * inv_r;
    const double dF_r = -E * (dkp2_r * G + kp2 * dG);
    ph_r = 0.5 * (dksqr_r + dwp2_r * F + wp2 * dF_r);

    const double dbr_th = -2.0 * bth, dbth_th = 0.5 * br;
    const double dbz_th = -3.0 * bth * c_th - 1.5 * br * s_th;
    const double dq3_th = inv_r * kt3 * dinv_s;
    const double dn_th = q1 * dbr_th + q2 * dbth_th + dq3_th * bph;
    const double dbm2_th = -3.0 * br * bth;
    const double dkp2_th = inv_bm2 * (2.0 * n * dn_th - kp2 * dbm2_th);
    gx[1] = 0.5 * (dksqr_th + w_fac * dbz_th * F - wp2 * aE * dkp2_th);

    const double dbr_ph = -2.0 * s_th * bph, dbth_ph = c_th * bph, dbph_ph = bnorm * P.sm * cp;
    const double dbz_ph = -3.0 * s_th * c_th * bph;
    const double dn_ph = q1 * dbr_ph + q2 * dbth_ph + q3 * dbph_ph;
    const double dbm2_ph = 2.0 * (br * dbr_ph + bth * dbth_ph + bph * dbph_ph);
    const double dkp2_ph = inv_bm2 * (2.0 * n * dn_ph - kp2 * dbm2_ph);
    gx[2] = 0.5 * (w_fac * dbz_ph * F - wp2 * aE * dkp2_ph);

    const double bs = bnorm * P.sm;
    const double wsp = P.omega * sp;
    const double dbr_t = 2.0 * bs * s_th * wsp, dbth_t = -bs * c_th * wsp;
    const double dbph_t = -bs * P.omega * cp;
    const double dbz_t = 3.0 * bs * s_th * c_th * wsp;
    const double dn_t = q1 * dbr_t + q2 * dbth_t + q3 * dbph_t;
    const double dbm2_t = 2.0 * (br * dbr_t + bth * dbth_t + bph * dbph_t);
    const double dkp2_t = inv_bm2 * (2.0 * n * dn_t - kp2 * dbm2_t);
    *gt = 0.5 * (w_fac * dbz_t * F - wp2 * aE * dkp2_t);
    if constexpr (disp_bndry(V)) {
      // the excess 0.5 (2 wpt bt + bt^2) F enters the time derivative only;
      // bt does not depend on time
      const double wpt = sqrt(fmax(wp2, 1e-30));
      const double bt = r > P.r_ns
          ? bndry_term(r, P.r_ns, P.bndry_pole_t, P.bndry_rmax, P.bndry_lyr) : 0.0;
      const double dwp2b = 2.0 * wpt * bt + bt * bt;
      const double dF_t = -aE * dkp2_t;
      *gt += 0.5 * ((bt / wpt) * (w_fac * dbz_t) * F + dwp2b * dF_t);
    }
  }
  gx[0] = x1 > P.r_ns ? ph_r : 0.0;
}

// Hand adjoint of the nondimensionalized Hamiltonians: dH~/dx (3), dH~/dk~ (3),
// dH~/dt.  Photon branch: the variant's dispersion (Melrose or isotropic),
// grad_h_photon; axion branch: metric only.  With the boundary layer
// only the photon's time derivative gains its term, its spatial gradients
// do not (the reference's quirk, RayTracer.jl:84-88).
template <int V = kMelrose>
static __device__ void grad_h_hand(const MegaParams& P, double x1, double x2, double x3, double kt1,
                            double kt2, double kt3, double time, double ergt_ph,
                            double ergt_ax, bool photon, double s_th, double c_th,
                            double gx[3], double gk[3], double* gt) {
  if (P.species == 1 || (P.species == 2 && !photon)) {
    const Metric<double> g = metric<double>(x1, s_th, P.rs0, P.r_metric);
    double d[4];
    dmetric_dr(x1, s_th, P.rs0, P.r_metric, d);
    gk[0] = g.rr * kt1;
    gk[1] = g.thth * kt2;
    gk[2] = g.pp * kt3;
    gx[0] = 0.5 * (d[0] * ergt_ax * ergt_ax + d[1] * kt1 * kt1 + d[2] * kt2 * kt2 +
                   d[3] * kt3 * kt3);
    gx[1] = -g.pp * (c_th / s_th) * kt3 * kt3;
    gx[2] = 0.0;
    *gt = 0.0;
    return;
  }
  double s_ph, c_ph, swt, cwt;
  sincos(x3, &s_ph, &c_ph);
  sincos(P.omega * time, &swt, &cwt);
  const double r = x1 > P.r_ns ? x1 : P.r_ns;
  if (r < P.r_metric)
    grad_h_photon<V, true>(P, x1, r, kt1, kt2, kt3, ergt_ph, s_th, c_th, s_ph, c_ph, swt, cwt,
                           gx, gk, gt);
  else
    grad_h_photon<V, false>(P, x1, r, kt1, kt2, kt3, ergt_ph, s_th, c_th, s_ph, c_ph, swt, cwt,
                            gx, gk, gt);
}

// Hamilton's equations in log time; g^rr at the ray's own r (pool semantics).
template <int V = kMelrose>
static __device__ void rhs(const MegaParams& P, const double* u, double lnt, double erg, bool photon,
                    double* du) {
  const double t = exp(lnt);
  const double inv_ma = 1.0 / P.mass_a;
  const double ek = erg * inv_ma;
  double s_th, c_th;
  sincos(u[1], &s_th, &c_th);
  const double g_rr = metric<double>(u[0], s_th, P.rs0, P.r_metric).rr;
  double gx[3], gk[3], gt;
  grad_h_hand<V>(P, u[0], u[1], u[2], u[3] * ek, u[4] * ek, u[5] * ek, t, -u[6] * inv_ma,
              erg * inv_ma, photon, s_th, c_th, gx, gk, &gt);
  const double ma2 = P.mass_a * P.mass_a;
  const double denom = photon ? -u[6] : erg;
  const double fac = C_KM * t * g_rr / denom;
  const bool frozen = photon && u[0] <= P.r_ns * 1.01;
  for (int i = 0; i < 3; ++i) {
    du[i] = frozen ? 0.0 : gk[i] * P.mass_a * fac;
    du[3 + i] = frozen ? 0.0 : -(gx[i] * ma2) * fac / erg;
  }
  du[6] = (frozen || !photon) ? 0.0 : gt * ma2 * t * g_rr / (-u[6]);
}

// Conversion probability p = 1 - exp(-P_nonAD) at a crossing state, with the
// gradients of wp, |B| and k.B^i differentiated by hand.  g^rr and its
// derivative take the metric's branch at r (interior below r_metric); the
// local energy's lapse and the Christoffel symbols are exterior everywhere,
// as in the host function (ops/conversion.get_prob_nonad).
static __device__ double prob_nd(const MegaParams& P, const double* u, double erg) {
  const double r = u[0];
  double s_th, c_th, s_ph, c_ph;
  sincos(u[1], &s_th, &c_th);
  sincos(u[2], &s_ph, &c_ph);
  const Metric<double> g = metric<double>(r, s_th, P.rs0_full, P.r_metric);
  const double inv_ma = 1.0 / P.mass_a;
  const double ek = erg * inv_ma;
  const double kt1 = u[3] * ek, kt2 = u[4] * ek, kt3 = u[5] * ek;
  const double lap = 1.0 - P.rs0_full / r;
  const double wt = fabs(u[6]) * inv_ma / sqrt(lap > 1e-10 ? lap : 1e-10);

  const double q = P.r_ns / r;
  const double bnorm = P.b0_sign * (q * q * q) * 0.5;
  const double br = 2.0 * bnorm * (P.cm * c_th + P.sm * s_th * c_ph);
  const double bth = bnorm * (P.cm * s_th - P.sm * c_th * c_ph);
  const double bph = bnorm * P.sm * s_ph;
  const double inv_r = 1.0 / r;
  const double abs_s = fabs(s_th);

  const double bz = br * c_th - bth * s_th;
  const double wp = sqrt(r <= P.r_ns ? 0.0 : P.wp2_scale * fabs(bz));
  const double sgn = bz > 0.0 ? 1.0 : (bz < 0.0 ? -1.0 : 0.0);
  const double dwp_fac = wp > 0.0 ? P.wp2_scale * sgn / (2.0 * wp) : 0.0;
  const double dmu_wp[3] = {dwp_fac * (-3.0 * bz * inv_r),
                            dwp_fac * (-3.0 * bth * c_th - 1.5 * br * s_th),
                            dwp_fac * (-3.0 * s_th * c_th * bph)};

  const double bmag = sqrt(br * br + bth * bth + bph * bph);
  const double dbph_ph = bnorm * P.sm * c_ph;
  const double dmu_b[3] = {
      -3.0 * bmag * inv_r, -1.5 * br * bth / bmag,
      (br * (-2.0 * s_th * bph) + bth * (c_th * bph) + bph * dbph_ph) / bmag};

  const double sqA = sqrt(g.rr);
  double dsqA;  // d sqrt(g^rr)/dr, on the metric's branch at r
  if (r < P.r_metric) {
    double d[4];
    dmetric_dr(r, s_th, P.rs0_full, P.r_metric, d);
    dsqA = 0.5 * d[1] / sqA;
  } else {
    dsqA = 0.5 * (P.rs0_full * inv_r * inv_r) / sqA;
  }
  const double inv_rs = inv_r / abs_s;
  const double term1[3] = {
      kt1 * (-3.0 * br * inv_r * sqA + br * dsqA) +
          kt2 * (-3.0 * bth * inv_r * inv_r - bth * inv_r * inv_r) +
          kt3 * (-3.0 * bph * inv_r * inv_rs - bph * inv_r * inv_rs),
      kt1 * (-2.0 * bth) * sqA + kt2 * (0.5 * br) * inv_r +
          kt3 * bph * (-c_th * inv_r / (s_th * abs_s)),
      kt1 * (-2.0 * s_th * bph) * sqA + kt2 * (c_th * bph) * inv_r + kt3 * dbph_ph * inv_rs};
  const double kb = kt1 * br * sqA + kt2 * bth * inv_r + kt3 * bph * inv_rs;

  const double bup1 = br * sqA, bup2 = bth * sqrt(g.thth), bup3 = bph * sqrt(g.pp);
  const double gm = P.gm_full;
  const double cot = c_th / s_th;
  const double g_rrr = -gm / (r * (r - 2.0 * gm));
  const double g_rtt = -(r - 2.0 * gm);
  const double g_rpp = -(r - 2.0 * gm) * s_th * s_th;
  const double kmag = sqrt(g.rr * kt1 * kt1 + g.thth * kt2 * kt2 + g.pp * kt3 * kt3);
  const double ct = kb / (kmag * bmag);
  const double st2r = 1.0 - ct * ct;
  const double st2 = st2r > 0.0 ? st2r : 0.0;
  const double t2b[3] = {
      kt1 * bup1 * g_rrr + kt2 * inv_r * bup2 + kt3 * inv_r * bup3,
      kt1 * bup2 * g_rtt + kt3 * cot * bup3 + kt2 * bup1 * inv_r,
      kt1 * bup3 * g_rpp + kt2 * (-s_th * c_th) * bup3 + kt3 * inv_r * bup1 + kt3 * cot * bup2};

  const double wp2 = wp * wp, wt2 = wt * wt;
  const double pre_f = wp / fabs(wt2 * wt2 * wt + ct * ct * wt * (wp2 * wp2 - 2.0 * wp2 * wt2));
  double dmu_e[3];
  for (int i = 0; i < 3; ++i) {
    const double dc = (term1[i] + t2b[i]) / (kmag * bmag) - ct * dmu_b[i] / bmag;
    dmu_e[i] = pre_f * (wt2 * wt2 * st2 * dmu_wp[i] - wt2 * ct * wp * (wt2 - wp2) * dc);
  }
  const double vhat_grad_e =
      (g.rr * kt1 * dmu_e[0] + g.thth * kt2 * dmu_e[1] + g.pp * kt3 * dmu_e[2]) / kmag;
  const double vl = wt2 - 1.0;
  const double vloc = sqrt(vl > 1e-12 ? vl : 1e-12) / wt;
  const double prefactor = wt2 * wt2 * st2 / (ct * ct * wp2 * (wp2 - 2.0 * wt2) + wt2 * wt2);
  const double p_nonad = P.prob_scale * prefactor * bmag * bmag / (fabs(vhat_grad_e) * vloc);
  const double p = 1.0 - exp(-p_nonad);
  return p < 0.0 ? 0.0 : (p > 1.0 ? 1.0 : p);
}

__device__ __forceinline__ void hermite(const double* u0, const double* u1, const double* f0,
                                        const double* f1, double h, double tau, double* out) {
  const double t2 = tau * tau, t3 = t2 * tau;
  const double a = 2 * t3 - 3 * t2 + 1, b = t3 - 2 * t2 + tau;
  const double c = -2 * t3 + 3 * t2, d = t3 - t2;
  for (int i = 0; i < 7; ++i) out[i] = a * u0[i] + b * h * f0[i] + c * u1[i] + d * h * f1[i];
}

__device__ __forceinline__ bool flipped(double a, double b) {
  const double sa = a > 0.0 ? 1.0 : (a < 0.0 ? -1.0 : 0.0);
  const double sb = b > 0.0 ? 1.0 : (b < 0.0 ? -1.0 : 0.0);
  return sa * sb < 0.0;
}

__device__ __forceinline__ double sgn(double a) {
  return a > 0.0 ? 1.0 : (a < 0.0 ? -1.0 : 0.0);
}

// Initial step of a launch (integrator._initial_dt), span = lnt1 - lnt > 0.
__device__ __forceinline__ double initial_dt(const MegaParams& P, const double* u,
                                             const double* f0, double span) {
  double d0 = 0.0, d1 = 0.0;
  for (int c = 0; c < 7; ++c) {
    const double sc = P.atol + P.rtol * fabs(u[c]);
    d0 += (u[c] / sc) * (u[c] / sc);
    d1 += (f0[c] / sc) * (f0[c] / sc);
  }
  d0 = sqrt(d0 / 7.0);
  d1 = sqrt(d1 / 7.0);
  const double dt = (d0 < 1e-5 || d1 < 1e-5) ? 1e-6 : 0.01 * d0 / d1;
  return fmin(dt, 0.1 * span);
}

// One integration in flight: K2 keeps one per ray, K3 one per tree node.
struct Ray {
  double u[7];   // state (r, theta, phi, w_r, w_th, w_ph, e7)
  double f0[7];  // derivative at u: the next step's first stage (FSAL)
  double lnt, dt, g0, errold, lnt_ck;
  int steps, n_cross, nfine, nbisect;  // nfine/nbisect: dense passes, bisected roots
  // K2's chain instantiation only (dp5_step_warp<V, true>): the slot of the
  // current segment's first crossing (the start-point rejection applies to
  // it) and the crossing count at which the segment stops
  int seg0, stop_n;
};

}  // namespace art
