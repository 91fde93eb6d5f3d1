"""Clear-text event/final/tree writers (saveMode >= 2).

Port of adiabatic_raytracer_tpu/utils/textio.py, numpy only.  The bytes are
the reference writers':
  * final_/event_ files   MainRunner.jl:565-611, 689-701, 737-738
  * tree files (saveNode) MainRunner.jl:17-65

The reference's plot/plotTree*.py parsers predate the tc/times lines of
saveNode and cannot parse its current output; the writer stays faithful to
saveNode and analysis/treeio.py parses it.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np

from adiabatic_raytracer_tpu_torch.utils.format import julia_str as _jstr


class EventFiles:
    """Append-mode event_/final_ writers (saveMode > 1)."""

    def __init__(self, dir_tag: str, file_tag: str, append: bool = False):
        os.makedirs(os.path.join(dir_tag, "event"), exist_ok=True)
        self.final_path = os.path.join(dir_tag, "event", "final_" + file_tag)
        self.event_path = os.path.join(dir_tag, "event", "event_" + file_tag)
        if not append:  # truncate at run start (MainRunner.jl:435-444);
            # append=True keeps the streams across a checkpoint resume
            open(self.final_path, "w").close()
            open(self.event_path, "w").close()

    def write_event_head(self, event_no: int, v_ifty, sln_prob, nb_x, nb_k,
                         xpos, k_init):
        with open(self.event_path, "a") as f:
            vals = ([event_no] + list(v_ifty) + [sln_prob] + list(nb_x) + list(nb_k)
                    + list(xpos) + list(k_init))
            f.write(" ".join(_jstr(int(v)) if isinstance(v, int) else _jstr(float(v))
                             for v in vals))

    def write_event_tail(self, wall_time: float, count: int):
        with open(self.event_path, "a") as f:
            f.write(f" {_jstr(float(wall_time))} {count}\n")

    def write_final(self, event_no: int, weight: float, species_id: int, theta_f,
                    phi_f, abs_f, theta_fx, phi_fx, abs_fx, t_node):
        with open(self.final_path, "a") as f:
            f.write(
                f"{event_no} {_jstr(float(weight))} {species_id} "
                f"{_jstr(float(theta_f))} {_jstr(float(phi_f))} {_jstr(float(abs_f))} "
                f"{_jstr(float(theta_fx))} {_jstr(float(phi_fx))} {_jstr(float(abs_fx))} "
                f"{_jstr(float(t_node))}\n"
            )


class TreeFile:
    """saveMode 3 per-event tree dump (saveNode, MainRunner.jl:17-65)."""

    def __init__(self, dir_tag: str, file_tag: str, event_no: int):
        os.makedirs(os.path.join(dir_tag, "tree"), exist_ok=True)
        self.path = os.path.join(dir_tag, "tree", f"tree_{file_tag}{event_no}")
        self._f = open(self.path, "w")

    def save_node(self, species: str, weight, prob, parent_weight,
                  xc: Optional[Iterable] = None, yc=None, zc=None, tc=None,
                  traj=None, times=None, x=None, y=None, z=None):
        f = self._f
        f.write(f"{species} {_jstr(float(weight))} {_jstr(float(prob))} "
                f"{_jstr(float(parent_weight))}\n")
        if xc is not None and len(list(xc)) > 0:
            for arr in (xc, yc, zc, tc):
                for v in arr:
                    f.write(f"  {_jstr(float(v))}")
                f.write("\n")
        else:
            f.write("-\n-\n-")
            f.write("\n")
        if traj is not None and len(traj) > 0:
            traj = np.asarray(traj)
            for col in range(3):
                for v in traj[:, col]:
                    f.write(f"  {_jstr(float(v))}")
                f.write("\n")
            for v in (times if times is not None else []):
                f.write(f"  {_jstr(float(v))}")
            f.write("\n")
        else:
            f.write(_jstr(float(x)))
            f.write("\n")
            f.write(_jstr(float(y)))
            f.write("\n")
            f.write(_jstr(float(z)))
            f.write("\n")

    def close(self):
        self._f.close()
