// One adaptive DP5 step run by a whole warp (32 lanes) on one integration:
// `dp5_step_warp`, the step of all three f64 kernels.  K2 (megakernel.cu)
// runs one ray per warp, K3 and K4 one event's tree per warp
// (tree_device.cuh).
//
// What the step computes is the serial algorithm of the pool engine
// (ops/integrator.py) and the plain models (ops/treekernel.py _scan_roots,
// _bisect):
//   * The serial chain (6 RHS stages, error norm, controller, midpoint,
//     commit, end codes) runs replicated: every lane does the same
//     operations on the same values, so the lanes hold identical registers
//     and nothing needs a broadcast.  Decisions that feed control flow
//     (accept, the end code) are still taken from lane 0 (__shfl_sync), so a
//     floating-point tie can never split the warp.
//   * The event scan is spread over the lanes.  Round r of a pass of K points
//     gives lane l the point j = 32 r + l + 1 <= K, at tau_j = (double)j / K
//     (j = K is the step's end, g_new); its left neighbour g(j - 1) comes from
//     __shfl_up_sync (lane 0: the previous round's last value) and the sign
//     changes from __ballot_sync.  The coarse gate is one such pass of Kc
//     points; the dense pass processes its roots in increasing j, at most
//     max_roots of them, records each that passes the filters while slots
//     are free, and stops at the root that fills the last slot.  Points are
//     evaluated eagerly, not lazily; each is a pure function of tau.
//   * The bisection is 32-way (bisect_warp): the serial halvings in rounds
//     of 5 levels, 12 condition latencies for the default 60.
// ops/treekernel.py holds plain models of the scan, the bisection and the
// pop (_scan_roots_warp, _bisect_warp, _pop_best_warp) that the CPU tests
// hold bit for bit against the serial algorithms.
#pragma once

#include "mega_device.cuh"

namespace art {

constexpr unsigned kFullMask = 0xffffffffu;

// The serial bisection (P.bisect halvings of [tlo, thi], keeping the half
// whose left end has glo's sign; _bisect in ops/treekernel.py) in rounds of
// up to 5 levels.  In a round, lane n - 1 holds node n = 1..31 of the
// round's bisection tree (node n's children are 2n, left, and 2n + 1,
// right): it rebuilds its interval by replaying tm = 0.5 * (lo + hi) along
// the path bits of n, the serial loop's own operations, so its tm is bit for
// bit the serial midpoint, and evaluates the condition there.  Then every lane walks the round's levels from the
// root, reading each node's tm and g by shuffle and applying the serial rule
// sgn(g) == sgn(glo) (sgn 0 included).  tlo and thi end as the serial ones.
template <int V>
__device__ __forceinline__ void bisect_warp(const MegaParams& P, const double* u0,
                                            const double* u1, const double* f0,
                                            const double* f1, double h, double lnt0, int lane,
                                            double& tlo, double& thi, double glo) {
  const int n = lane + 1;
  const int depth = 31 - __clz(n);
  for (int left = P.bisect; left > 0;) {
    const int levels = left < 5 ? left : 5;
    double lo = tlo, hi = thi;
    for (int d = depth - 1; d >= 0; --d) {
      const double m = 0.5 * (lo + hi);
      if ((n >> d) & 1) lo = m;
      else hi = m;
    }
    const double tm = 0.5 * (lo + hi);
    double gm = 0.0;
    if (depth < levels) {
      double um[7];
      hermite(u0, u1, f0, f1, h, tm, um);
      gm = condition<V>(P, um, lnt0 + tm * h);
    }
    int node = 1;
    for (int d = 0; d < levels; ++d) {
      const double tn = __shfl_sync(kFullMask, tm, node - 1);
      const double gn = __shfl_sync(kFullMask, gm, node - 1);
      if (sgn(gn) == sgn(glo)) {
        tlo = tn;
        glo = gn;
        node = 2 * node + 1;
      } else {
        thi = tn;
        node = 2 * node;
      }
    }
    left -= levels;
  }
}

// One round of a scan pass of K points over the accepted step [lnt0, lnt0 +
// h]: lane l's point j = base + l + 1 (g_end where j == K), g(j - 1) in *gp
// (lane 0: carry), the lanes whose pair (g(j - 1), g(j)) changed sign as a
// ballot; carry becomes the round's last value.  Gate: the coarse pass's
// samples (condition<V, true>: the native gate trig where the library has
// it).
template <int V, bool Gate = false>
__device__ __forceinline__ unsigned scan_round(const MegaParams& P, const double* u0,
                                               const double* u1, const double* f0,
                                               const double* f1, double h, double lnt0,
                                               double g_end, int K, int base, int lane,
                                               double& carry, double* gj, double* gp) {
  const int j = base + lane + 1;
  double g = g_end;
  if (j < K) {
    const double tau = (double)j / K;
    double uj[7];
    hermite(u0, u1, f0, f1, h, tau, uj);
    g = condition<V, Gate>(P, uj, lnt0 + tau * h);
  }
  double left = __shfl_up_sync(kFullMask, g, 1);
  if (lane == 0) left = carry;
  carry = __shfl_sync(kFullMask, g, 31);
  *gj = g;
  *gp = left;
  return __ballot_sync(kFullMask, j <= K && flipped(left, g));
}

// One attempted adaptive DP5 step of R towards lnt1, run by all 32 lanes of
// a warp on the same integration (R identical in every lane), committed when
// accepted, then the gated event scan of the accepted step: the coarse pass
// (interp_coarse points) decides whether the dense pass (interp points)
// runs; each sign change of the dense pass, up to max_roots per step and in
// order, is bisected on the Hermite interpolant, and a root that passes the
// start-point (first crossing only) and r < 1.01 r_NS filters is handed to
// record(u_root, lnt_root, slot) while R.n_cross < max_crossings.  The
// crossing that fills the last slot ends the integration at the root.  If
// save_mid is given and the accepted step spans lnt_mid, the interpolant at
// lnt_mid is written there (K2's midpoint; K3 and K4 pass nullptr).
// Returns 0 to go on, else the end code, warp-uniform: 1 lnt1 reached, 2
// photon at the star, 3 crossing cap, 4 step cap, 5 stalled.  V is the
// dispersion variant (physics.cuh Disp) of the RHS and the condition; K3 and
// K4 run only the Melrose one.  Chain (K2's chain instantiation): the
// start-point rejection applies to the crossing in slot R.seg0, the first of
// the current segment, and the crossing cap is R.stop_n instead of
// P.max_crossings; without it the step is the code every other kernel runs.
// A library built with ART_PROFILE (K2's bench-only step profiles, the
// reference's MEGA_PROFILE, megakernel.py:925-928 and :1098-1146 there)
// runs no event block: 1 "scan" the gated scan (R.nfine counts the dense
// passes, the roots found end it as they end the production pass), 2
// "coarse" the coarse pass alone (R.nfine counts the steps whose gate would
// run the dense pass), 3 "rhs" no condition at all (g_new = 0).
template <int V = kMelrose, bool Chain = false, class Record>
__device__ __forceinline__ int dp5_step_warp(const MegaParams& P, Ray& R, double lnt1, double erg,
                                             bool photon, const double x0c[3], double lnt_mid,
                                             double* save_mid, int lane, Record&& record) {
  double k[7][7];
  for (int c = 0; c < 7; ++c) k[0][c] = R.f0[c];
  double h = fmin(R.dt, lnt1 - R.lnt);
  h = h > 0.0 ? h : 0.0;
#pragma unroll 1
  for (int s = 1; s < 7; ++s) {
    double ui[7];
    for (int c = 0; c < 7; ++c) {
      double acc = 0.0;
      for (int j = 0; j < s; ++j)
        if (kA[s][j] != 0.0) acc += kA[s][j] * k[j][c];
      ui[c] = R.u[c] + h * acc;
    }
    rhs<V>(P, ui, R.lnt + kC[s] * h, erg, photon, k[s]);
  }
  double u_new[7];
  double err = 0.0;
  for (int c = 0; c < 7; ++c) {
    double acc = 0.0, e = 0.0;
    for (int j = 0; j < 7; ++j) {
      if (j < 6 && kA[6][j] != 0.0) acc += kA[6][j] * k[j][c];
      if (kE[j] != 0.0) e += kE[j] * k[j][c];
    }
    u_new[c] = R.u[c] + h * acc;
    e = h * e;
    const double sc = P.atol + P.rtol * fmax(fabs(R.u[c]), fabs(u_new[c]));
    err += (e / sc) * (e / sc);
  }
  const double enorm = sqrt(err / 7.0);
  const bool forced = R.dt <= P.dt_min * 1.0000001;
  const bool accept =
      __shfl_sync(kFullMask, (int)((enorm <= 1.0 || forced) && h > 0.0), 0) != 0;
  const double en_safe = enorm > 0.0 ? enorm : 1e-10;
  double fac;
  if (P.pi_beta != 0.0) {
    fac = P.safety * pow(en_safe, -P.expo1) * pow(R.errold, P.pi_beta);
    fac = fmin(fmax(fac, P.min_fac), P.max_fac);
    if (!accept) fac = fmin(fac, 1.0);
  } else {
    fac = fmin(fmax(P.safety * pow(en_safe, -0.2), P.min_fac), P.max_fac);
  }
  const double dt_next = fmax(R.dt * fac, P.dt_min);
  const double t1 = R.lnt + h;
  if (save_mid != nullptr && accept && lnt_mid > R.lnt && lnt_mid <= t1)
    hermite(R.u, u_new, k[0], k[6], h, (lnt_mid - R.lnt) / h, save_mid);
#if ART_PROFILE == 3
  const double g_new = 0.0;
#else
  const double g_new = condition<V>(P, u_new, t1);
#endif

  // commit (the pool's order: the event scan below uses the step's start)
  double u_prev[7];
  for (int c = 0; c < 7; ++c) u_prev[c] = R.u[c];
  const double lnt_prev = R.lnt, g_prev = R.g0;
  if (accept) {
    for (int c = 0; c < 7; ++c) R.u[c] = u_new[c];
    R.lnt = t1;
    R.g0 = g_new;
    R.errold = fmax(enorm, 1e-4);
  }
  R.dt = dt_next;
  R.steps += 1;

  int code = 0;
  bool done = false;
#if ART_PROFILE != 3
  if (accept) {
    // gate: the coarse pass, then the dense pass only if this step needs it
    const int K = P.interp;
#if ART_PROFILE == 2
    const int Kc = P.interp_coarse > 0 ? P.interp_coarse : 4;
#else
    const int Kc = P.interp_coarse;
#endif
    bool dense = true;
    if (Kc > 0) {
      bool flip_c = false;
      bool low = fabs(g_prev) < P.gate_theta;
      double carry = g_prev, gj, gp;
      for (int base = 0; base < Kc; base += 32) {
        flip_c = scan_round<V, true>(P, u_prev, u_new, k[0], k[6], h, lnt_prev, g_new, Kc, base,
                                     lane, carry, &gj, &gp) != 0u || flip_c;
        low = __any_sync(kFullMask, base + lane + 1 <= Kc && fabs(gj) < P.gate_theta) || low;
      }
      dense = flip_c || low;
    }
#if ART_PROFILE == 2
    R.nfine += dense ? 1 : 0;
    dense = false;
#endif
    if (dense) {
      R.nfine += 1;
      int roots = 0;
      double carry = g_prev;
      for (int base = 0; base < K && roots < P.max_roots && !done; base += 32) {
        double gj, gp;
        unsigned flips = scan_round<V>(P, u_prev, u_new, k[0], k[6], h, lnt_prev, g_new, K, base,
                                    lane, carry, &gj, &gp);
#if ART_PROFILE == 1
        roots += __popc(flips);
        flips = 0u;
#endif
        while (flips != 0u && roots < P.max_roots && !done) {
          const int l = __ffs(flips) - 1;
          flips &= flips - 1u;
          const int j = base + l + 1;
          roots += 1;
          R.nbisect += 1;
          double tlo = (double)(j - 1) / K, thi = (double)j / K;
          bisect_warp<V>(P, u_prev, u_new, k[0], k[6], h, lnt_prev, lane, tlo, thi,
                      __shfl_sync(kFullMask, gp, l));
          const double ts = 0.5 * (tlo + thi);
          double us[7];
          hermite(u_prev, u_new, k[0], k[6], h, ts, us);
          const double lnt_s = lnt_prev + ts * h;
          double sth, cth, sph, cph;
          sincos(us[1], &sth, &cth);
          sincos(us[2], &sph, &cph);
          const double pc[3] = {us[0] * sth * cph, us[0] * sth * sph, us[0] * cth};
          bool within = true;
          for (int c = 0; c < 3; ++c)
            within = within && fabs(pc[c]) < fabs(x0c[c]) * 1.0001 &&
                     fabs(pc[c]) > fabs(x0c[c]) / 1.0001;
          const bool start_dup = within && R.n_cross == (Chain ? R.seg0 : 0);
          const bool below = us[0] < P.r_ns * 1.01;
          if (!start_dup && !below && R.n_cross < P.max_crossings) {
            record(us, lnt_s, R.n_cross);
            R.n_cross += 1;
            if (R.n_cross >= (Chain ? R.stop_n : P.max_crossings)) {  // cap: stop there
              for (int c = 0; c < 7; ++c) R.u[c] = us[c];
              R.lnt = lnt_s;
              code = 3;
              done = true;
            }
          }
        }
      }
    }
  }
#endif

  if (accept)  // FSAL: the accepted step's last stage starts the next step
    for (int c = 0; c < 7; ++c) R.f0[c] = k[6][c];
  if (!done) {
    const bool ns = accept && photon && R.u[0] < P.r_ns * 1.01;
    const bool reached = accept && t1 >= lnt1 - 1e-14;
    const bool maxed = R.steps >= P.max_steps;
    bool stalled = false;
    if (P.stall_window > 0 && R.steps % P.stall_window == 0) {
      stalled = R.lnt - R.lnt_ck < P.stall_min;
      R.lnt_ck = R.lnt;
    }
    code = ns ? 2 : reached ? 1 : maxed ? 4 : stalled ? 5 : 0;
  }
  return __shfl_sync(kFullMask, code, 0);
}

// Rare-fail guard (MainRunner.jl:213-224): a Cartesian proper-velocity
// component above 1 at the crossing (geometry.celerity_to_cart_vel).  K3 and
// K4 test it at every recorded crossing, K2's chain at each crossing it
// would continue through.
static __device__ bool rare_velocity(const MegaParams& P, const double* u, double erg) {
  const double r = u[0];
  double sth, cth, sph, cph;
  sincos(u[1], &sth, &cth);
  sincos(u[2], &sph, &cph);
  const double a = 1.0 - P.rs0 / r;
  const double v_r = u[3] * erg * sqrt(a) * a;
  const double v_t = u[4] * erg / r * a;
  const double v_p = u[5] * erg / (r * sth) * a;
  const double v_tmp = sth * v_r + cth * v_t;
  const double vx = cph * v_tmp - sph * v_p;
  const double vy = sph * v_tmp + cph * v_p;
  const double vz = cth * v_r - sth * v_t;
  return fabs(vx) > 1.0 || fabs(vy) > 1.0 || fabs(vz) > 1.0;
}

// A child's birth at the recorded crossing us (MainRunner.jl:278-305), the
// one block that K3's and K4's segment end and K2's chain share: returns the
// MC draw u_draw < p (the node's uniform against the crossing's conversion
// probability); uc gets the birth state, the crossing's momenta renormalized
// onto the axion shell at the event energy with the full-NS-mass metric, in
// place, phi as integrated (the host's relaunch goes through Cartesian
// coordinates and launch_state, which wraps phi into (-pi, pi]: the error
// norm then takes other steps, ROADMAP Queue 3), and dw_child the child's
// Delta_omega.
// ops/megakernel.py child_birth is its torch twin.
__device__ __forceinline__ bool child_birth(const MegaParams& P, const double* us, double erg,
                                            double u_draw, double p, double uc[7],
                                            double* dw_child) {
  const double r_s = us[0] > P.r_ns ? us[0] : P.r_ns;
  const Metric<double> g = metric<double>(r_s, sin(us[1]), P.rs0_full, P.r_metric);
  const double wsq = g.rr * us[3] * us[3] + g.thth * us[4] * us[4] + g.pp * us[5] * us[5];
  const double et = erg / P.mass_a;
  const double nn = (-g.tt * et * et - 1.0) / (et * et * wsq);
  const double nrm = sqrt(nn > 0.0 ? nn : 0.0);
  for (int c = 0; c < 3; ++c) {
    uc[c] = us[c];
    uc[3 + c] = us[3 + c] * nrm;
  }
  uc[6] = us[6];
  *dw_child = us[6] / erg;
  return u_draw < p;
}

}  // namespace art
