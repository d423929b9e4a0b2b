"""The generator's shared parts.  A traffic mix (``traffic/<mix>.json``)
and a configuration (``configs/<config>.json``) name a ``kind``, which
must agree; the kind is a module of its own, ``kinds/<kind>.py``, found
by that name (``Registry.kind``).  Its class ``Kind(config, traffic,
seed, device)`` makes, from the seed, the inputs of every unit of work,
drives the program's entry with them and hands the same inputs to the
plain reference.  What a run asks of it:

* ``scans_per_unit``: the scans a unit registers;
* ``setup_program()`` / ``drop_program()``: the program's set-up, and
  freeing what it holds before the reference runs;
* ``unit(k)``: the inputs of unit k; ``run(inputs)``: the program's
  output of a unit, on the device;
* ``failed(output)``: the scans of a unit whose result is not finite;
* ``check(outputs, units, walk)``: the numbers that decide ``correct``
  (named as in ``limits/<workload>.json``) for the program's outputs of
  ``units`` against the plain reference, from one pass of the reference;
  with ``walk``, also the summed bound (ms) and the number of the pruned
  1-NN calls that those units issue, by kernel (``'k2'``, ``'k2l'``), or
  None where the configuration runs none;
* ``control(units)``: the same numbers for the control, the plain
  reference one precision step below the configuration's, put in the
  program's place.

Everything is made on the run's device, from ``torch.Generator``s seeded
with the run's seed; the window only gathers rows of the pools.

What ``run.py`` calls, in this order, so that a kind whose program keeps
state from unit to unit (an online runner's map and window) can be
written as a module alone:

1. ``Kind(config, traffic, seed, device)``, then ``setup_program()``;
2. the warm-up: ``run(unit(0))`` once, its output read back and dropped;
3. the window: ``run(unit(k))`` for k = 0, 1, 2, ... until the window
   closes, each output read back to the host and kept as ``outputs[k]``
   (unit 0 so runs twice, after the warm-up's);
4. with ``--trace 1``, the units of the seeded sample run again, each
   as ``run(unit(k))`` in the sample's order, on the card: once under the
   device-only profile (``tracing.profile_units``), the first of them
   once more under the host's profile (``tracing.idle_gaps``), then all
   twice with the program's spans kept (``stages.span_passes``); on the
   CPU only once, with the spans kept;
5. ``drop_program()``, then ``check(outputs, sample, walk)`` with the
   window's outputs alone.

So the reruns of step 4 find the program's state as the window left it
and move it on, and nothing they return is compared: ``check`` works the
sampled units out again from the units' inputs (``unit(j)``, j up to k
where a unit depends on those before it), never from the program's
state.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

from benchmark import reference as rf
from benchmark import yardstick as ys


def seeded(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def icp_config(icp: dict):
    """The program's ``IcpConfig`` from a configuration's ``icp``."""
    from laser_slam_tpu_torch.config import IcpConfig
    return IcpConfig(**icp)


def pose_gaps(R_ref: torch.Tensor, t_ref: torch.Tensor, R: torch.Tensor,
              t: torch.Tensor) -> Dict[str, float]:
    """Largest translation (m) and rotation (deg) gaps of the poses (R,
    t) from (R_ref, t_ref), in float64; a NaN pose reads as an infinite
    gap."""
    dm = torch.linalg.norm(t.double() - t_ref.double(), dim=-1).max()
    dd = rf.rotation_angle_deg(R_ref.double(), R.double()).max()
    return {'pose_gap_m': float(torch.nan_to_num(dm, nan=math.inf)),
            'pose_gap_deg': float(torch.nan_to_num(dd, nan=math.inf))}


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """The largest of each number over ``readings``."""
    out: Dict[str, float] = {}
    for r in readings:
        for name, v in r.items():
            out[name] = max(out.get(name, 0.0), v)
    return out


def check_poses(kind, outputs: dict, units, walk: bool = False):
    """``check`` of a kind whose ``reference(k, prec, keep_iterates)``
    gives poses (R, t) and its pruned 1-NN calls, and whose
    ``compared(output)`` gives the program's pose7 of the same poses."""
    walk = walk and pruned(kind.config['icp'])
    gaps, calls = [], []
    for k in units:
        R_ref, t_ref, c = kind.reference(k, rf.F64, keep_iterates=walk)
        R, t = rf.pose7_to_rt(kind.compared(outputs[k].to(kind.device)))
        gaps.append(pose_gaps(R_ref, t_ref, R, t))
        calls.extend(c)
    cutoff = kind.config['icp']['max_correspondence_dist_m']
    return worst(gaps), (walk_bounds(calls, cutoff) if walk else None)


def control_poses(kind, units) -> Dict[str, float]:
    """``control`` of such a kind: the reference in TF32 against the
    reference in float64."""
    gaps = []
    for k in units:
        R_c, t_c, _ = kind.reference(k, rf.TF32)
        R_r, t_r, _ = kind.reference(k, rf.F64)
        gaps.append(pose_gaps(R_r, t_r, R_c, t_c))
    return worst(gaps)


def walk_bounds(calls, cutoff: float) -> Tuple[dict, dict]:
    """(summed bound ms, number of calls), each by kernel ('k2l' against
    per-lane references, 'k2' against a shared one), of the pruned 1-NN
    calls ``(queries, reference, per_lane)``."""
    bound, count = {}, {}
    for q, ref, per_lane in calls:
        kind = 'k2l' if per_lane else 'k2'
        bound[kind] = bound.get(kind, 0.0) + ys.nn_call_bound_ms(
            q, ref, cutoff, per_lane)
        count[kind] = count.get(kind, 0) + 1
    return bound, count


def pruned(icp: dict) -> bool:
    """Whether the configuration's ICP runs the pruned 1-NN (K2, K2L)."""
    return icp['matcher'] == 'pallas' and bool(icp['pallas_prune'])


def make(reg, config: dict, traffic: dict, seed: int, device):
    """The inputs and calls of a cell: the kind that ``traffic`` names,
    found by name in ``reg``."""
    kind = traffic['kind']
    if config.get('kind') != kind:
        raise ValueError(f"configuration kind {config.get('kind')!r} does not "
                         f"serve traffic kind {kind!r}")
    return reg.kind(kind).Kind(config, traffic, seed, device)
