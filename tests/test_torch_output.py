"""The saveMode 2/3 output path and the forward tree's streaming window of
the port against the JAX package: the text writers byte for byte, the tree
reader, the port's CLI at saveMode 3 against the JAX CLI's pinned files, and
the window against the unwindowed engine and against JAX's windowed engine."""

import os

import numpy as np
import pytest
import torch

from adiabatic_raytracer_tpu.analysis import treeio as jtreeio
from adiabatic_raytracer_tpu.utils import textio as jtextio
from adiabatic_raytracer_tpu_torch import config as tcfg
from adiabatic_raytracer_tpu_torch.analysis import treeio
from adiabatic_raytracer_tpu_torch.cli import run_from_args
from adiabatic_raytracer_tpu_torch.models.magnetosphere import conversion_surface_radius
from adiabatic_raytracer_tpu_torch.ops import sampler, tree
from adiabatic_raytracer_tpu_torch.ops.dispersion import k_norm_cart
from adiabatic_raytracer_tpu_torch.utils import rng, textio

from test_torch_e2e import GOLDEN_ARGS, _check_golden

torch.set_num_threads(1)


def _vals(g, n):
    """n floats over the magnitudes the writers meet (1e-9 .. 1e41), signed."""
    return list(g.standard_normal(n) * 10.0 ** g.integers(-9, 42, n))


def _write(mod, d, case, g):
    """One writer call of `case` through `mod` (the JAX or the port textio)."""
    if case in ("event", "final"):
        ev = mod.EventFiles(str(d), "w")
        if case == "event":
            ev.write_event_head(7, _vals(g, 3), _vals(g, 1)[0], *(_vals(g, 3) for _ in range(4)))
            ev.write_event_tail(float(abs(_vals(g, 1)[0])), 12)
        else:
            ev.write_final(7, float(_vals(g, 1)[0]), 1, *_vals(g, 7))
        return [ev.event_path, ev.final_path]
    tf = mod.TreeFile(str(d), "w", 7)
    cross = case.startswith("cross")
    xc = dict(xc=_vals(g, 2), yc=_vals(g, 2), zc=_vals(g, 2), tc=_vals(g, 2)) if cross else {}
    if case.endswith("traj"):
        tf.save_node("photon", 0.25, *_vals(g, 2), traj=np.array(_vals(g, 9)).reshape(3, 3),
                     times=[-30.0, -15.0, 0.0], **xc)
    else:
        tf.save_node("axion", *_vals(g, 3), x=_vals(g, 1)[0], y=1.0, z=0.0, **xc)
    tf.close()
    return [tf.path]


@pytest.mark.parametrize("case", ["event", "final", "cross_traj", "nocross_traj",
                                  "cross_point", "nocross_point"])
def test_writers_byte_identical(tmp_path, case):
    """(a) The port's EventFiles/TreeFile against JAX utils/textio.py on the
    same inputs from a seed: byte-identical files."""
    paths = {}
    for tag, mod in (("jax", jtextio), ("port", textio)):
        paths[tag] = _write(mod, tmp_path / tag, case, np.random.default_rng(5))
    for pj, pp in zip(paths["jax"], paths["port"]):
        with open(pj, "rb") as fj, open(pp, "rb") as fp:
            assert fp.read() == fj.read(), os.path.basename(pp)
    assert any(os.path.getsize(p) for p in paths["port"])


def test_reader_matches_jax(tmp_path):
    """(b) The port's treeio loaders against JAX's on the same files."""
    g = np.random.default_rng(8)
    tf = textio.TreeFile(str(tmp_path), "r", 1)
    for case in ("cross_traj", "nocross_traj"):
        xc = (dict(xc=_vals(g, 2), yc=_vals(g, 2), zc=_vals(g, 2), tc=_vals(g, 2))
              if case.startswith("cross") else {})
        tf.save_node("photon", *np.abs(_vals(g, 3)), traj=np.array(_vals(g, 9)).reshape(3, 3),
                     times=[-30.0, -15.0, 0.0], **xc)
    tf.close()
    ev = textio.EventFiles(str(tmp_path), "r")
    for en in (1, 2):
        ev.write_event_head(en, _vals(g, 3), 1e41, *(_vals(g, 3) for _ in range(4)))
        ev.write_final(en, 0.5, 1, *_vals(g, 7))
        ev.write_event_tail(0.125, 3)
    nodes, nodes_j = treeio.load_tree(tf.path), jtreeio.load_tree(tf.path)
    assert len(nodes) == len(nodes_j) == 2 and [len(n["crossings_x"]) for n in nodes] == [2, 0]
    for n, nj in zip(nodes, nodes_j):
        assert n.keys() == nj.keys()
        for k in n:
            np.testing.assert_array_equal(n[k], nj[k], k)
    assert treeio.tree_weight_sum(nodes) == jtreeio.tree_weight_sum(nodes_j)
    for fn in ("load_event_info", "load_final_info"):
        path = ev.event_path if fn == "load_event_info" else ev.final_path
        for a, b in zip(getattr(treeio, fn)(path), getattr(jtreeio, fn)(path)):
            np.testing.assert_array_equal(a, b)
    assert (treeio.convergence_summary(ev.event_path, ev.final_path)
            == jtreeio.convergence_summary(ev.event_path, ev.final_path))


# (c) pinned from the JAX CLI's files:
#   python -m adiabatic_raytracer_tpu --Nts 4 --seed 1769 --ThetaM 0.2 --saveMode 3 \
#       --event_batch 3 --platform cpu
# final_ lines: event, weight, species, theta_f, phi_f, |k_f|, theta_fx, phi_fx, |x_f|, t
JAX_FINALS = [
    [1, 0.001376467853127948, 1, 2.775945284657105, -0.8765957061032673, 9.99971130994663e-06, 2.7759296043876382, -0.8766248566260672, 299754.21829990565, 0.0],
    [2, 0.010481470090213234, 1, 0.4601980503946071, 2.2486426736408243, 9.999684302914648e-06, 0.46020808476975544, 2.248657728373993, 299739.89138307364, 4.9688194572117196e-05],
    [2, 8.541496042828678e-05, 0, 2.3985285345829808, 2.423132110801135, 1.8748228422198895e-07, 2.3721540678424144, 2.4264044516120324, 8412.619794942819, 7.733041482774805e-05],
    [2, 6.643452694416127e-05, 0, 1.6045212195934546, 2.382786834268318, 1.8744028262815784e-07, 1.5927544513703322, 2.3853071889266206, 8417.360668724206, 4.9688194572117196e-05],
    [2, 3.158485651035942e-07, 1, 0.5067387522247792, 2.3200620993123335, 9.99987092812734e-06, 0.5067741110253415, 2.3200819690696775, 299741.9723022361, 7.733041482774805e-05],
    [3, 0.0007854252128060854, 1, 0.47731685382435374, 1.473510595589362, 9.999906027426516e-06, 0.4773500273731269, 1.4735844072483948, 299765.44349964074, 0.0],
]
# event_ lines without the per-event wall time (second-last column)
JAX_EVENTS = [
    [1, 0.00042368396346865664, 0.00042368396065230125, 0.0004236839550489395, 1.503280141483241e+41, -2697.1849222141072, 2842.3903962217046, 4692.595789223505, -3.360331577439054e-08, 4.1420509177706066e-08, 5.625587514013113e-08, 5.435579772470892, -12.480823210213781, -6.97574470027584, 1.7564305056011023e-06, -1.6261449927536835e-06, -3.1384706872297862e-06, 1],
    [2, 0.00042368395260012514, 0.0004236839654691318, 0.000423683969820748, 2.2101317027805197e+40, 3656.851730058026, -3424.936904816229, 6757.488371576612, 8.486170404525309e-08, -7.879556585871627e-08, 1.4744281528476697e-07, -8.312587252897876, 5.759509873117894, 12.389048657111964, 3.371549028539696e-07, 1.1917705888299016e-08, -3.865565987534538e-06, 7],
    [3, 0.0004236839677251889, 0.00042368396969612613, 0.0004236839591381777, 1.5441354497432359e+41, 5218.7435060444395, -3014.1381842028522, 1388.085534285628, 7.0351081299686e-08, -3.357781509567839e-08, 2.4627079808605886e-08, -8.969801016523991, 14.804693109842162, 5.684179966780686, 5.095197981171972e-07, 2.59961503558068e-06, 2.562103284262563e-06, 1],
]
# tree_<event>: (species, crossings, weight, prob, parent weight) per node
JAX_TREES = {
    1: [
        ('axion', 3, 0.951136755885035, 0.0014471818533047243, 1.0),
        ('photon', 0, 1.0, 0.0014471818533047243, 1.0),
    ],
    2: [
        ('axion', 1, 0.993520692201915, 0.010702983349630824, 1.0),
        ('photon', 1, 1.0, 0.010702983349630824, 1.0),
        ('photon', 1, 0.9919377705217769, 0.9919377705217769, 1.0),
        ('axion', 1, 0.008062229478223104, 0.008062229478223104, 1.0),
        ('photon', 0, 0.9856901868608982, 0.9937016374952711, 0.9919377705217769),
        ('axion', 0, 0.008032526695266409, 0.9963158102808998, 0.008062229478223104),
        ('axion', 0, 0.006247583660878767, 0.006298362504728927, 0.9919377705217769),
        ('photon', 0, 2.970278295669636e-05, 0.003684189719100228, 0.008062229478223104),
    ],
    3: [
        ('axion', 1, 0.9978125201140504, 0.000787147081213524, 1.0),
        ('photon', 0, 1.0, 0.000787147081213524, 1.0),
    ],
}


@pytest.fixture(scope="module")
def sm3(tmp_path_factory):
    """The port's CLI at saveMode 3 on CPU (the golden flags, one batch of 3)."""
    d = tmp_path_factory.mktemp("sm3")
    args = list(GOLDEN_ARGS)
    args[args.index("--saveMode") + 1] = "3"
    rows, _, _ = run_from_args(args + ["--dir_tag", str(d)])
    return d, rows


def _assert_lines(got, want):
    """Integers exact, floats at rtol 1e-6."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, int):
                assert a == b and float(a).is_integer()
            else:
                assert a == pytest.approx(b, rel=1e-6, abs=0.0)


def test_savemode3_final_and_event_lines(sm3):
    d, _ = sm3
    with open(d / "event" / "final_") as f:
        _assert_lines([[float(t) for t in ln.split()] for ln in f], JAX_FINALS)
    with open(d / "event" / "event_") as f:
        lines = [[float(t) for t in ln.split()] for ln in f]
    _assert_lines([ln[:-2] + ln[-1:] for ln in lines], JAX_EVENTS)
    assert all(ln[-2] > 0 for ln in lines)          # the wall time per event


def test_savemode3_tree_files(sm3):
    d, _ = sm3
    assert sorted(os.listdir(d / "tree")) == [f"tree_{e}" for e in JAX_TREES]
    for e, want in JAX_TREES.items():
        nodes = treeio.load_tree(str(d / "tree" / f"tree_{e}"))
        assert [(n["species"], len(n["crossings_x"])) for n in nodes] == [w[:2] for w in want]
        np.testing.assert_allclose([[n["weight"], n["prob"], n["parent_weight"]] for n in nodes],
                                   [w[2:] for w in want], rtol=1e-6, atol=0)
        for n in nodes:
            assert all(len(n[c]) == 3 for c in ("x", "y", "z", "times"))


def test_savemode3_rows_are_golden(sm3):
    _check_golden(sm3[1])


# (f) the streaming window: 6 events of the test_tree.py scene, sampled with
# the port's sampler, the tree ended early (lnt_end -11) so that each
# iteration costs ~1 s on the eager CPU engine
WIN_SC = tcfg.Scene(theta_m=0.4)
WIN_TC = tcfg.TreeConfig(num_cutoff=3, mc_nodes=2, max_nodes=8)
WIN_NUM = dict(interp_points=8, max_crossings=8)
WIN_LNT_END = -11.0


@pytest.fixture(scope="module")
def win_events():
    maxR = float(conversion_surface_radius(WIN_SC.mass_a, WIN_SC.theta_m, WIN_SC.omega_pul,
                                           WIN_SC.b0, WIN_SC.r_ns))
    n_grid = sampler.default_n_grid(maxR, scan_per_step=8)
    key = rng.PRNGKey(2)
    xs, vs, es = [], [], []
    while len(xs) < 6:
        key, sub = rng.split(key).unbind(0)
        r = sampler.sample_batch(sub, 16, maxR, WIN_SC, WIN_SC.mass_ns, n_grid=n_grid)
        for i in r.success.nonzero().squeeze(1).tolist():
            xs.append(r.xpos[i])
            vs.append(r.v_loc[i])
            es.append(r.erg_inf[i])
    x, v, e = torch.stack(xs[:6]), torch.stack(vs[:6]), torch.stack(es[:6])
    return x, k_norm_cart(x, v, 0.0, e, WIN_SC, WIN_SC.mass_ns, is_photon=True, ax_fix=True), e


def _tree(ev, **kw):
    x, k, e = ev
    return tree.forward_tree(rng.PRNGKey(9), x, k, e, WIN_SC, tcfg.NumericsConfig(**WIN_NUM, **kw),
                             WIN_TC, lnt_end=WIN_LNT_END)


def test_window_bitwise_unwindowed(win_events):
    """(f) At equal K the windowed engine is bitwise the unwindowed one in
    every per-event field but the schedule (n_iters, done_it), as JAX
    tests/test_tree.py::test_streaming_window_matches_batch holds JAX's."""
    a, b = _tree(win_events, tree_k=4), _tree(win_events, tree_k=4, tree_window=2)
    for name in a._fields:
        if name in ("n_iters", "done_it"):
            continue
        va, vb = getattr(a, name), getattr(b, name)
        for fa, fb, f in (zip(va, vb, va._fields) if name == "pools" else [(va, vb, name)]):
            assert torch.equal(fa, fb), f
    assert int(b.n_iters[0]) > int(a.n_iters[0]) and int(b.done_it.max()) > int(a.done_it.max())


def test_window_auto_k_matches_jax(win_events):
    """(f) At auto K = 1 the port's windowed engine is JAX forward_tree's at
    tree_window=2 (its outputs pinned below): counters and the window's
    schedule exact, node records at rtol 1e-9 (2.2e-13 measured: the pool's
    autograd RHS against jax.grad)."""
    tr = _tree(win_events, tree_window=2)
    for name, want in JAX_WINDOW_COUNTERS.items():
        assert getattr(tr, name).tolist() == want, name
    pl = tr.pools
    got = []
    for e in range(6):
        proc = (pl.status[e] == 2).nonzero().squeeze(1)
        for p in proc[torch.argsort(pl.order[e, proc])].tolist():
            got.append((e, int(pl.order[e, p]), bool(pl.is_photon[e, p]), bool(pl.is_final[e, p]),
                        float(pl.weight[e, p]), float(pl.prob[e, p])))
    assert [g[:4] for g in got] == [w[:4] for w in JAX_WINDOW_NODES]
    np.testing.assert_allclose([g[4:] for g in got], [w[4:] for w in JAX_WINDOW_NODES],
                               rtol=1e-9, atol=0)


# JAX forward_tree at tree_window=2 (auto K = 1) on win_events, pinned:
#   jax.random.PRNGKey(9), NumericsConfig(interp_points=8, max_crossings=8,
#   tree_window=2), TreeConfig(num_cutoff=3, mc_nodes=2, max_nodes=8),
#   Scene(theta_m=0.4), lnt_end=-11.0; nodes: (event, order, photon, final,
#   weight, prob) of every processed node
JAX_WINDOW_COUNTERS = {'count': [3, 3, 1, 1, 1, 1], 'count_main': [2, 2, 1, 1, 1, 1], 'info': [-2, -2, 2, 2, 2, 2], 'n_alloc': [3, 3, 1, 1, 1, 1], 'dw_anomalies': [0, 0, 0, 0, 0, 0], 'n_iters': [5, 5, 5, 5, 5, 5], 'done_it': [3, 3, 4, 4, 5, 5]}
JAX_WINDOW_NODES = [
    (0, 1, True, False, 1.0, 0.0022676941049633026),
    (0, 2, True, True, 0.9976934545470041, 0.9976934545470041),
    (0, 3, False, True, 0.0023065454529959117, 0.0023065454529959117),
    (1, 1, True, False, 1.0, 0.0027896431558146473),
    (1, 2, True, True, 0.9970188424174369, 0.9970188424174369),
    (1, 3, False, True, 0.002981157582563121, 0.002981157582563121),
    (2, 1, True, True, 1.0, 0.0014295207082619665),
    (3, 1, True, True, 1.0, 0.0010658964589395081),
    (4, 1, True, True, 1.0, 0.0008438569639785953),
    (5, 1, True, True, 1.0, 0.0017849787223916946),
]
