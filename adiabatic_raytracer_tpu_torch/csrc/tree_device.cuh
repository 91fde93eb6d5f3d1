// One event's forward branching tree, f64, run by one warp: the body shared
// by K3 (treekernel.cu, one warp per event) and K4 (treerefill.cu, warps
// pulling events from a queue per partition).
//
// Transcribed from the JAX reference's step body (adiabatic_raytracer_tpu/
// ops/treekernel.py _make_step_body), with the host engine's semantics where
// the two differ (ops/treekernel.py of the port says which).  `tree_run`
// integrates the event's current node with the warp's DP5 step
// (art::dp5_step_warp, tree_warp.cuh: species mixed, one crossing slot,
// in-kernel probability), and at each segment end
//   * an exit without a recorded crossing writes a final record into the
//     event's row of `fin` (or flags an overflow once count_main >= NF);
//   * a recorded crossing passes the rare-fail guard, then pushes its
//     children onto the event's pending queue: both in the branching phase,
//     the drawn one in MC mode (MainRunner.jl:278-305), the draw being the
//     pre-drawn uniform of this node's index;
//   * the per-node cutoffs run in the reference's order (overflow, 2
//     prob_cutoff, 3 num_cutoff, 4 max_nodes);
//   * the max-weight pending node is popped (ties to the lower pool slot)
//     and integrated from its birth state with a fresh initial step.
// It stops when the tree is done or after `budget` iterations (a step, or a
// node born at or after lnt1); then the event's whole state is in its rows,
// and a later call resumes it (f0 and g0 are recomputed from the committed
// state, which is what FSAL carried).
//
// The warp: every lane holds the same registers and runs the serial parts
// replicated; the step's event scan and bisection use the lanes
// (tree_warp.cuh).  At a segment end, lane s < QD reads queue slot s: the
// free slots for a push come from a ballot, the pop is a warp argmax by
// shuffles under the serial rule (largest weight, then the lower pool slot),
// and the popped index is taken from lane 0.  A final record or a pushed slot
// (16 rows) is written by lanes 0..15, one row each, in one store, with a
// __syncwarp() before any lane reads what another wrote.  Lane 0 writes the
// event's aux and u rows back.
//
// Layout: every block is row-major per event, the JAX wrapper's own API
// layout (ops/treekernel.py holds the row indices): uio [E, 16] (u in 0..6;
// rows 7 and 8 count the event's photon steps begun and crossings recorded
// below r_metric, where the metric takes its interior branch),
// aux [E, 32] (integrator and node registers), uni [E, UU] (uniform of node
// index n at n - 1), q [E, QD, 16] (the pending queue) and fin [E, NF, 16]
// (final records).  uio, aux, q and fin are updated in place.
//
// Everything here has internal linkage or is inline (no anonymous namespace
// inside `art`: nvcc's generated stubs reject it in a shared header).
#pragma once

#include "tree_warp.cuh"

// Tree scalars passed by value at launch (ops/treekernel.py TreeParams).
// it_cap is K3's step budget per event per launch; K4 takes its own.
struct TreeParams {
  double prob_cutoff;
  int mc_nodes, num_cutoff, max_nodes, nf, qd, uu, it_cap;
};

namespace art {

// aux rows
constexpr int A_LNT = 0, A_ERROLD = 1, A_DT = 2, A_STEPS = 3, A_LNTCK = 4, A_ISPH = 5,
              A_DONE = 6, A_INFO = 7, A_COUNT = 8, A_CMAIN = 9, A_TOTP = 10, A_ANOM = 11,
              A_NALLOC = 12, A_WCUR = 13, A_PROB = 14, A_PCONV = 15, A_PCONV0 = 16,
              A_TB = 17, A_DW = 18, A_ORD = 19, A_X0X = 20, A_X0Y = 21, A_X0Z = 22,
              A_ITERS = 23, A_ERG = 24, A_LNT1 = 25, A_STEPTOT = 26, A_NFINE = 27,
              A_NBISECT = 28, A_STEPS_PH = 29, A_NCROSS = 30, A_NACC = 31, AUX_ROWS = 32;
// queue slot rows
constexpr int Q_U0 = 0, Q_LNT = 7, Q_ISPH = 8, Q_W = 9, Q_PROB = 10, Q_PCONV = 11,
              Q_PCONV0 = 12, Q_DW = 13, Q_SLOT = 14, Q_ST = 15, Q_ROWS = 16;
// final slot rows
constexpr int F_VALID = 0, F_ISFIN = 1, F_ISPH = 2, F_ORD = 3, F_W = 4, F_PROB = 5,
              F_PCONV = 6, F_PCONV0 = 7, F_TB = 8, F_U0 = 9, F_ROWS = 16;
constexpr int U_ROWS = 16, U_PH_IN = 7, U_CROSS_IN = 8;
constexpr double INFO_OVERFLOW = 9.0;  // needs the host replay

// Rare-fail guard (MainRunner.jl:213-224): a Cartesian proper-velocity
// component above 1 at the crossing (geometry.celerity_to_cart_vel).
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

// Lanes 0..15 each store row `lane` of a 16-row record at dst.
__device__ __forceinline__ void store_rows(double* dst, const double (&v)[16], int lane) {
  double x = v[0];
#pragma unroll
  for (int r = 1; r < 16; ++r) x = lane == r ? v[r] : x;
  if (lane < 16) dst[lane] = x;
}

// A pending-queue slot: u(7), lnt, is_ph, weight, prob, pconv, pconv0, dw,
// pool slot, status 1.
__device__ __forceinline__ void write_slot(double* q, const double* u, double lnt, double is_ph,
                                           double w, double prob, double pconv, double pconv0,
                                           double dw, double slot, int lane) {
  const double v[16] = {u[0], u[1], u[2], u[3], u[4], u[5], u[6], lnt,
                        is_ph, w, prob, pconv, pconv0, dw, slot, 1.0};
  store_rows(q, v, lane);
}

// Runs event i's tree (its aux row must have A_DONE clear) for at most
// `budget` iterations, with all 32 lanes of the warp.  Writes every row of
// its state back, A_ITERS excepted (each kernel keeps its own count there),
// adds this call's work to the work counters (rows 27-31; row 26 is the
// event's running step total), and returns whether the tree is done
// (warp-uniform); *used gets the iterations it ran.
__device__ __forceinline__ bool tree_run(const MegaParams& P, const TreeParams& T, double* uio,
                                         double* aux, const double* uni, double* q,
                                         double* fin, size_t i, int budget, int lane,
                                         int* used) {
  double* a = aux + i * AUX_ROWS;
  double* qs = q + i * T.qd * Q_ROWS;
  double* fs = fin + i * T.nf * F_ROWS;
  const double* un = uni + i * T.uu;
  double* uu = uio + i * U_ROWS;

  const double erg = a[A_ERG], lnt1 = a[A_LNT1];
  bool photon = a[A_ISPH] > 0.5;
  double x0c[3] = {a[A_X0X], a[A_X0Y], a[A_X0Z]};
  double count = a[A_COUNT], cmain = a[A_CMAIN], totp = a[A_TOTP], anom = a[A_ANOM];
  double nall = a[A_NALLOC], info = a[A_INFO], w = a[A_WCUR], prob = a[A_PROB];
  double pconv = a[A_PCONV], pconv0 = a[A_PCONV0], tb = a[A_TB], dw = a[A_DW];
  double ord = a[A_ORD], steptot = a[A_STEPTOT];

  Ray R;
  for (int c = 0; c < 7; ++c) R.u[c] = uu[c];
  R.lnt = a[A_LNT];
  R.errold = a[A_ERROLD];
  R.steps = (int)a[A_STEPS];
  R.lnt_ck = a[A_LNTCK];
  R.n_cross = 0;  // a segment ends at its first recorded crossing
  R.nfine = 0;
  R.nbisect = 0;
  rhs(P, R.u, R.lnt, erg, photon, R.f0);
  R.g0 = condition(P, R.u, R.lnt);
  R.dt = a[A_DT] > 0.0 ? a[A_DT] : initial_dt(P, R.u, R.f0, lnt1 - R.lnt);

  // work of this call for the bound: photon steps, accepted steps,
  // recorded crossings (each evaluates prob_nd once); and the photon steps
  // begun and crossings recorded below r_metric
  int n_ph = 0, n_acc = 0, n_rec = 0, n_ph_in = 0, n_rec_in = 0;
  double ustar[7], lnt_star = 0.0, p_star = 0.0;
  auto record = [&](const double* us, double lnt_s, int) {
    for (int c = 0; c < 7; ++c) ustar[c] = us[c];
    lnt_star = lnt_s;
    p_star = P.with_prob ? prob_nd(P, us, erg) : 0.0;
    n_rec += 1;
    n_rec_in += us[0] < P.r_metric ? 1 : 0;
  };

  bool done = false;
  int it = 0;
  for (; it < budget && !done; ++it) {
    int code = 1;  // a node born at or after lnt1 ends at once, without a crossing
    if (R.lnt < lnt1) {
      const double lnt_prev = R.lnt;  // an accepted step always advances lnt
      n_ph_in += photon && R.u[0] < P.r_metric ? 1 : 0;
      code = dp5_step_warp(P, R, lnt1, erg, photon, x0c, 0.0, nullptr, lane, record);
      steptot += 1.0;
      n_ph += photon ? 1 : 0;
      n_acc += R.lnt != lnt_prev ? 1 : 0;
    }
    if (code == 0) continue;

    // ---- segment end ----
    const bool cross = code == 3;
    const bool rare = cross && rare_velocity(P, ustar, erg);
    bool overflow = false;
    if (!cross || rare) totp += w;
    if (!cross) {  // final node (MainRunner.jl:200-207)
      if (cmain < T.nf - 0.5) {
        const double v[16] = {1.0, R.u[0] > P.r_ns * 1.1 ? 1.0 : 0.0, photon ? 1.0 : 0.0,
                              ord, w, prob, pconv, pconv0, tb, R.u[0], R.u[1], R.u[2],
                              R.u[3], R.u[4], R.u[5], R.u[6]};
        store_rows(fs + (int)cmain * F_ROWS, v, lane);
      } else {
        overflow = true;
      }
      cmain += 1.0;
    } else if (!rare) {  // children (MainRunner.jl:278-305)
      const bool mc = ord > T.mc_nodes + 0.5;
      const int ix = (int)ord - 1;  // node index n draws fold_in(event_key, n)
      const double u_draw = (ix >= 0 && ix < T.uu) ? un[ix] : 0.0;
      const bool conv = u_draw < p_star;
      // birth state: the crossing's momenta renormalized onto the axion
      // shell at the event energy, in place (the host's launch_state does a
      // Cartesian round trip; in f64 the two differ by rounding)
      const double r_s = ustar[0] > P.r_ns ? ustar[0] : P.r_ns;
      const Metric<double> g = metric<double>(r_s, sin(ustar[1]), P.rs0_full, P.r_metric);
      const double wsq =
          g.rr * ustar[3] * ustar[3] + g.thth * ustar[4] * ustar[4] + g.pp * ustar[5] * ustar[5];
      const double et = erg / P.mass_a;
      const double nn = (-g.tt * et * et - 1.0) / (et * et * wsq);
      const double nrm = sqrt(nn > 0.0 ? nn : 0.0);
      const double uc[7] = {ustar[0], ustar[1], ustar[2], ustar[3] * nrm,
                            ustar[4] * nrm, ustar[5] * nrm, ustar[6]};
      const double dw_child = ustar[6] / erg;
      const double is_ph = photon ? 1.0 : 0.0, flip = photon ? 0.0 : 1.0;
      const double spA = mc ? (conv ? flip : is_ph) : flip;
      const double wA = mc ? w : p_star * w;
      const double probA = mc ? (conv ? p_star : 1.0 - p_star) : p_star;
      const double pconv0A = mc ? (conv ? p_star : pconv) : p_star;
      const bool push_b = !mc;
      // the first (and second) free slot in slot order; a slot is free
      // unless its status is > 0.5
      int sa = -1, sb = -1;
      for (int base = 0; base < T.qd && sb < 0; base += 32) {
        const int s = base + lane;
        unsigned fr = __ballot_sync(kFullMask, s < T.qd && !(qs[s * Q_ROWS + Q_ST] > 0.5));
        for (; fr != 0u && sb < 0; fr &= fr - 1u) {
          if (sa < 0) sa = base + __ffs(fr) - 1;
          else sb = base + __ffs(fr) - 1;
        }
      }
      if (sa >= 0)
        write_slot(qs + sa * Q_ROWS, uc, lnt_star, spA, wA, probA, p_star, pconv0A, dw_child,
                   nall, lane);
      if (push_b && sb >= 0)
        write_slot(qs + sb * Q_ROWS, uc, lnt_star, is_ph, (1.0 - p_star) * w, 1.0 - p_star,
                   p_star, pconv, dw_child, nall + 1.0, lane);
      __syncwarp();
      // QD = mc_nodes + 2 bounds the pending count, so a failed push means
      // a shrunk queue: the host replays the event
      if (sa < 0 || (push_b && sb < 0)) overflow = true;
      nall += mc ? 1.0 : 2.0;
    }

    // per-node cutoffs (MainRunner.jl:324-339); an overflow goes first, since
    // the host replay recomputes the whole event
    bool stop = true;
    if (overflow) info = INFO_OVERFLOW;
    else if (totp >= 1.0 - T.prob_cutoff) info = 2.0;
    else if (cmain >= T.num_cutoff - 0.5) info = 3.0;
    else if (count > T.max_nodes + 0.5) info = 4.0;
    else stop = false;

    if (!stop) {  // pop the max-weight pending node, ties to the lower pool slot
      // each lane's best of its slots s = lane, lane + 32, ... by the serial
      // rule, then a butterfly over the lanes (ties last to the lower slot
      // index, so the order is total and every lane ends with the serial pick)
      int best = -1;
      double bw = 0.0, bslot = 0.0;
      for (int s = lane; s < T.qd; s += 32) {
        const double* qsl = qs + s * Q_ROWS;
        if (qsl[Q_ST] < 0.5) continue;
        const double ws = qsl[Q_W], sl = qsl[Q_SLOT];
        if (best < 0 || ws > bw || (ws == bw && sl < bslot)) {
          best = s;
          bw = ws;
          bslot = sl;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const int ob = __shfl_xor_sync(kFullMask, best, off);
        const double ow = __shfl_xor_sync(kFullMask, bw, off);
        const double osl = __shfl_xor_sync(kFullMask, bslot, off);
        if (ob >= 0 && (best < 0 || ow > bw ||
                        (ow == bw && (osl < bslot || (osl == bslot && ob < best))))) {
          best = ob;
          bw = ow;
          bslot = osl;
        }
      }
      best = __shfl_sync(kFullMask, best, 0);
      if (best < 0) {
        stop = true;  // worklist exhausted: info stays 1
      } else {
        double* qb = qs + best * Q_ROWS;
        count += 1.0;
        ord = count;
        dw = qb[Q_DW];
        if (dw > -0.5 || dw < -2.0) anom += 1.0;
        for (int c = 0; c < 7; ++c) R.u[c] = qb[Q_U0 + c];
        R.lnt = qb[Q_LNT];
        photon = qb[Q_ISPH] > 0.5;
        w = qb[Q_W];
        prob = qb[Q_PROB];
        pconv = qb[Q_PCONV];
        pconv0 = qb[Q_PCONV0];
        if (lane == 0) qb[Q_ST] = 0.0;
        __syncwarp();
        tb = exp(R.lnt);
        rhs(P, R.u, R.lnt, erg, photon, R.f0);
        R.g0 = condition(P, R.u, R.lnt);
        R.dt = initial_dt(P, R.u, R.f0, lnt1 - R.lnt);
        R.steps = 0;
        R.lnt_ck = R.lnt;
        R.errold = 1e-4;
        R.n_cross = 0;
        double st, ct, sp, cp;
        sincos(R.u[1], &st, &ct);
        sincos(R.u[2], &sp, &cp);
        x0c[0] = R.u[0] * st * cp;
        x0c[1] = R.u[0] * st * sp;
        x0c[2] = R.u[0] * ct;
      }
    }
    done = stop;
  }

  if (lane == 0) {
    for (int c = 0; c < 7; ++c) uu[c] = R.u[c];
    uu[U_PH_IN] += n_ph_in;
    uu[U_CROSS_IN] += n_rec_in;
    a[A_LNT] = R.lnt;
    a[A_ERROLD] = R.errold;
    a[A_DT] = R.dt;
    a[A_STEPS] = R.steps;
    a[A_LNTCK] = R.lnt_ck;
    a[A_ISPH] = photon ? 1.0 : 0.0;
    a[A_DONE] = done ? 1.0 : 0.0;
    a[A_INFO] = info;
    a[A_COUNT] = count;
    a[A_CMAIN] = cmain;
    a[A_TOTP] = totp;
    a[A_ANOM] = anom;
    a[A_NALLOC] = nall;
    a[A_WCUR] = w;
    a[A_PROB] = prob;
    a[A_PCONV] = pconv;
    a[A_PCONV0] = pconv0;
    a[A_TB] = tb;
    a[A_DW] = dw;
    a[A_ORD] = ord;
    a[A_X0X] = x0c[0];
    a[A_X0Y] = x0c[1];
    a[A_X0Z] = x0c[2];
    a[A_STEPTOT] = steptot;
    a[A_NFINE] += R.nfine;
    a[A_NBISECT] += R.nbisect;
    a[A_STEPS_PH] += n_ph;
    a[A_NCROSS] += n_rec;
    a[A_NACC] += n_acc;
  }
  *used = it;
  return done;
}

}  // namespace art
