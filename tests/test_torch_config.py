"""Port configs against the JAX classes; the import boundary; unported options."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from adiabatic_raytracer_tpu import config as jcfg
from adiabatic_raytracer_tpu_torch import config as tcfg
from adiabatic_raytracer_tpu_torch.driver import check_ported
from adiabatic_raytracer_tpu_torch.utils import rng

torch.set_num_threads(1)

PAIRS = [(jcfg.Scene, tcfg.Scene), (jcfg.NumericsConfig, tcfg.NumericsConfig),
         (jcfg.TreeConfig, tcfg.TreeConfig)]


@pytest.mark.parametrize("jax_cls,port_cls", PAIRS, ids=lambda c: c.__name__)
def test_fields_and_defaults_match(jax_cls, port_cls):
    jf = [(f.name, f.default) for f in dataclasses.fields(jax_cls)]
    pf = [(f.name, f.default) for f in dataclasses.fields(port_cls)]
    assert jf == pf
    assert port_cls.__dataclass_params__.frozen


def test_from_jax_dict_round_trip():
    sc = jcfg.Scene(mass_a=2e-6, theta_m=0.4, b0=3e13, v_ns=(0.1, 0.0, -0.2), flat=True)
    nc = jcfg.NumericsConfig(rtol=1e-8, interp_coarse=8, engine="mega", pi_beta=0.04)
    tc = jcfg.TreeConfig(num_cutoff=50, mc_nodes=8, prob_cutoff=1e-12)
    d = {name: {k: np.asarray(v) for k, v in dataclasses.asdict(c).items()}
         for name, c in (("scene", sc), ("numerics", nc), ("tree", tc))}
    psc, pnc, ptc = tcfg.from_jax_dict(d)
    for jc, pc in ((sc, psc), (nc, pnc), (tc, ptc)):
        for f in dataclasses.fields(jc):
            want = getattr(jc, f.name)
            got = getattr(pc, f.name)
            assert got == (tuple(want) if isinstance(want, (list, tuple)) else want), f.name
    assert psc.mass_ns_eff == 0.0
    with pytest.raises(ValueError):
        tcfg.from_jax_dict({"scene": {"not_a_field": 1}})


def test_jax_key_converter():
    import jax

    k = jax.random.fold_in(jax.random.PRNGKey(1769), 5)
    kt = rng.key_from_jax(np.asarray(k))
    assert kt.dtype == torch.int64 and kt.tolist() == np.asarray(k).astype(np.int64).tolist()
    np.testing.assert_array_equal(rng.key_to_jax(kt), np.asarray(k))


def test_port_never_imports_jax():
    """Every module of the port imports with jax made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import adiabatic_raytracer_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')\n"
        "         if not m.name.endswith('__main__')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items()\n"
        "               if v is not None)\n"
        "assert 'adiabatic_raytracer_tpu' not in sys.modules\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


@pytest.mark.parametrize("kw", [
    dict(cfg=dict(backtrace_chunk=64)),
], ids=lambda kw: str(kw))
def test_unported_options_raise(kw):
    cfg = tcfg.NumericsConfig(**kw.pop("cfg", {}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_ported(cfg, **kw)


@pytest.mark.parametrize("kw", [
    dict(cfg=dict(tree_window=128)),
    dict(save_mode=2),
    dict(checkpoint=True),
    dict(resume=True),
    dict(cfg=dict(engine="pool_compact")),
    dict(mesh_devices=4),
    dict(pipeline_depth=2),
    dict(mesh_devices=2, processes=1),
    dict(mesh_devices=1, processes=2),
    dict(mesh_devices=2, processes=2),
    dict(cfg=dict(mc_chain=1)),
], ids=lambda kw: str(kw))
def test_ported_options_pass(kw):
    """The streaming window, saveMode 2/3, checkpoint/resume, pool_compact,
    a mesh, pipeline depth 2, processes each running their own shard, a
    mesh over the process group and the in-kernel MC chain are ported:
    check_ported lets them pass."""
    check_ported(tcfg.NumericsConfig(**kw.pop("cfg", {})), **kw)


def test_mesh_larger_than_group_raises(tmp_path):
    """A mesh over a group takes one device per process: a mesh larger than
    the group raises naming the missing device, in check_ported (the CLI
    calls it before it joins the group), in make_mesh and in driver.run
    under a group of one process, before anything runs."""
    import socket

    from adiabatic_raytracer_tpu_torch.driver import run
    from adiabatic_raytracer_tpu_torch.parallel import mesh

    with pytest.raises(ValueError, match="process 2's device is missing"):
        check_ported(tcfg.NumericsConfig(), mesh_devices=3, processes=2)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    assert not mesh.process_group_exists()
    mesh.init_distributed(f"127.0.0.1:{port}", 1, 0, timeout_s=60)
    try:
        assert [tuple(sh) for sh in mesh.make_mesh(1, "cpu")] == [(0, torch.device("cpu"))]
        with pytest.raises(RuntimeError, match=r"process 1's device \(cpu there\) is missing"):
            mesh.make_mesh(2, "cpu")
        with pytest.raises(RuntimeError, match="process 1's device"):
            run(tcfg.Scene(theta_m=0.2), tcfg.NumericsConfig(), tcfg.TreeConfig(), 3, seed=1,
                dir_tag=str(tmp_path), device="cpu", mesh_devices=2)
    finally:
        mesh.leave_group()
    assert not list(tmp_path.iterdir())
    assert len(mesh.make_mesh(2, "cpu")) == 2      # without a group: virtual shards again


def test_cli_takes_every_jax_run_flag():
    """The port's CLI accepts every flag of the JAX CLI but --platform (the
    port's --device takes its place); --precision takes f32 and f64, which
    driver.state_dtype resolves to the state dtype."""
    from adiabatic_raytracer_tpu.cli import build_parser as jax_parser
    from adiabatic_raytracer_tpu_torch.cli import build_parser

    flags = lambda p: {s for a in p._actions for s in a.option_strings}
    assert flags(jax_parser()) - {"--platform"} <= flags(build_parser())
    args = build_parser().parse_args(
        ["--engine", "pool_compact", "--mesh", "2", "--pipeline_depth", "2", "--profile_dir",
         "prof", "--coordinator", "127.0.0.1:29500", "--nprocs", "2", "--procid", "1"])
    assert (args.engine, args.mesh, args.pipeline_depth, args.profile_dir, args.coordinator,
            args.nprocs, args.procid) == ("pool_compact", 2, 2, "prof", "127.0.0.1:29500",
                                          2, 1)
    from adiabatic_raytracer_tpu_torch.driver import state_dtype

    for prec, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        assert state_dtype(build_parser().parse_args(["--precision", prec]).precision) == dtype
    assert build_parser().parse_args([]).precision == "f64"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--precision", "f16"])


def test_mesh_without_its_cards_raises(tmp_path):
    """--mesh 2 --device cuda on a machine with fewer than two cards raises
    naming the missing card, and runs nothing on the CPU."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices are present")
    from adiabatic_raytracer_tpu_torch.cli import run_from_args
    from adiabatic_raytracer_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match=f"cuda:{torch.cuda.device_count()} is missing"):
        make_mesh(2, "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        run_from_args(["--Nts", "4", "--seed", "1", "--ThetaM", "0.2", "--mesh", "2",
                       "--device", "cuda", "--dir_tag", str(tmp_path)])
    assert not list((tmp_path / "npy").glob("*.npy"))
    assert len(make_mesh(2, "cpu")) == 2


def test_scan_gate_census_defaults_to_the_card():
    """Like every entry point of the port, the census check runs on the card
    unless the caller asks for the CPU."""
    import inspect

    from adiabatic_raytracer_tpu_torch.driver import scan_gate_census_check

    assert inspect.signature(scan_gate_census_check).parameters["device"].default == "cuda"


def test_tree_refill_is_ported():
    """K4 runs where the kernel tree engine runs: check_ported lets it pass."""
    check_ported(tcfg.NumericsConfig(engine="mega", tree_engine="kernel", tree_refill=1))
    check_ported(tcfg.NumericsConfig(tree_refill=128, tree_refill_k=3), save_mode=1)


def test_from_jax_dict_carries_tree_kernel_fields():
    nc = jcfg.NumericsConfig(tree_engine="kernel", tree_kernel_finals=7, tree_kernel_chunk=32)
    d = {"numerics": {k: np.asarray(v) for k, v in dataclasses.asdict(nc).items()}}
    _, pnc, _ = tcfg.from_jax_dict(d)
    assert (pnc.tree_engine, pnc.tree_kernel_finals, pnc.tree_kernel_chunk) == ("kernel", 7, 32)


def test_kernel_tree_engine_needs_covered_scene():
    """tree_engine='kernel' raises, naming the ROADMAP item, on what K3 does
    not cover: another engine, or a scene without the in-kernel probability."""
    from adiabatic_raytracer_tpu_torch.ops.tree import check_tree_engine, kernel_covers

    kern = dict(tree_engine="kernel", engine="mega")
    for sc, cfg in ((tcfg.Scene(), dict(kern, engine="pool")),
                    (tcfg.Scene(bndry_lyr=1.0), kern), (tcfg.Scene(isotropic=True), kern),
                    (tcfg.Scene(), dict(kern, in_kernel_prob=0))):
        assert not kernel_covers(sc, tcfg.NumericsConfig(**cfg))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            check_tree_engine(sc, tcfg.NumericsConfig(**cfg))
    assert kernel_covers(tcfg.Scene(theta_m=0.2), tcfg.NumericsConfig(**kern))
    check_tree_engine(tcfg.Scene(theta_m=0.2), tcfg.NumericsConfig(**kern))
    check_ported(tcfg.NumericsConfig(**kern))


def test_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from adiabatic_raytracer_tpu_torch.driver import run

    with pytest.raises(RuntimeError, match="cuda"):
        run(tcfg.Scene(theta_m=0.2), tcfg.NumericsConfig(engine="mega"),
            tcfg.TreeConfig(), 3, seed=1, dir_tag=str(tmp_path), device="cuda")


def test_cli_default_device_is_cuda(tmp_path):
    """With no --device flag the CLI runs on the card: without one it raises
    naming cuda and runs nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from adiabatic_raytracer_tpu_torch.cli import build_parser, run_from_args

    assert build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        run_from_args(["--Nts", "4", "--seed", "1", "--ThetaM", "0.2",
                       "--dir_tag", str(tmp_path)])
    assert not list((tmp_path / "npy").glob("*.npy"))
