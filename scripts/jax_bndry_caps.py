"""Hold the caps K2's rays reached on the card to the JAX package's pool
engine on the CPU: each ray that chip_smoke.py's phase 28d recorded as
having filled its crossing slots, reached max_steps or stalled
(chip_smoke.k2_caps) is run again from its launch inputs through the JAX
package's `propagate` (the pool engine, f64), and the cap that run reaches
is printed beside the card's.  A reference check on the CPU, not part of
the port: it imports the JAX package and runs without a card.

    JAX_PLATFORMS=cpu python3 scripts/jax_bndry_caps.py \\
        [chiprun_out/chip_smoke/bndry_caps.json]

Prints one JSON line per ray and a last line with the counts; exits 1 if a
ray's cap is one the JAX pool does not reach on it.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
DEFAULT = os.path.join(HERE, "chiprun_out", "chip_smoke", "bndry_caps.json")


def jax_caps(rays):
    """The cap the JAX pool reaches on each of a group of recorded rays that
    share their scene, species, slots and max_steps (one jitted propagate
    over the group; each ray's result is independent of the others):
    ("slots full", "max_steps", "stalled" or None, steps, crossings) per
    ray."""
    import jax
    import jax.numpy as jnp

    from adiabatic_raytracer_tpu.config import NumericsConfig, Scene
    from adiabatic_raytracer_tpu.ops.propagate import propagate

    f64 = jnp.float64
    first = rays[0]
    sc = Scene(**dict(first["scene"], v_ns=tuple(first["scene"]["v_ns"])))
    cfg = NumericsConfig(atol=1e-6, rtol=1e-7, engine="pool", max_steps=first["max_steps"])
    col = lambda n, dt=f64: jnp.asarray([r[n] for r in rays], dtype=dt)
    B = len(rays)
    res = jax.jit(lambda x0, k0, erg, dw, l0, l1, ph: propagate(
        x0, k0, sc, cfg, erg=erg, delta_w=dw, lnt0=l0, lnt1=l1, is_photon=ph,
        max_crossings=jnp.full((B,), first["slots"], dtype=jnp.int32),
        species=first["species"]))(col("x0"), col("k0"), col("erg"), col("delta_w"),
                                   col("lnt0"), col("lnt1"), col("is_photon", bool))
    out = []
    for i in range(B):
        steps = int(res.steps[i])
        # propagate's maxed is the step cap alone; a ray the stall detector
        # cut ended short of lnt1 with none of the other ends
        short = float(res.final_lnt[i]) < rays[i]["lnt1"] - 1e-14
        if bool(res.maxed[i]):
            cap = "max_steps"
        elif first["species"] == "axion" and bool(res.cut_short[i]):
            cap = "slots full"
        elif short and not bool(res.ns_hit[i]) and not bool(res.cut_short[i]):
            cap = "stalled"
        else:
            cap = None
        out.append((cap, steps, int(res.n_cross[i])))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    import jax

    jax.config.update("jax_enable_x64", True)
    path = argv[0] if argv else DEFAULT
    rays = json.load(open(path))
    groups = {}
    for ray in rays:
        key = json.dumps([ray["scene"], ray["species"], ray["slots"], ray["max_steps"]])
        groups.setdefault(key, []).append(ray)
    same = 0
    for group in groups.values():
        for ray, (cap, steps, n_cross) in zip(group, jax_caps(group)):
            same += cap == ray["cap"]
            print(json.dumps(dict(scene=ray["grid_scene"], launch=ray["launch"],
                                  lane=ray["lane"], species=ray["species"], card=ray["cap"],
                                  card_steps=ray["steps"], jax_pool=cap, jax_steps=steps,
                                  jax_crossings=n_cross)), flush=True)
    print(json.dumps(dict(rays=len(rays), jax_pool_reaches_the_same_cap=same)))
    return 0 if same == len(rays) else 1


if __name__ == "__main__":
    sys.exit(main())
