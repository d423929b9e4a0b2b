"""Pose-graph factors as fixed-capacity tensors.

Counterpart of ``laser_slam_tpu/graph/factors.py``: the padded graph the
solver reads.  An inactive slot has weight 0, and factor removal is a
weight write, never a reshape.  Relative factors have residual
log(meas^-1 * Ta^-1 * Tb); prior factors log(meas^-1 * T).  Noise models
are diagonal sqrt-information 6-vectors ([rot, trans]).

``HostGraph`` (the host-side factor store of the object API) is still
to be ported (ROADMAP queue 1); the online path keeps its factors in
``OnlineState``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FactorGraphData(NamedTuple):
    """Padded device representation of the factor graph."""
    # Relative factors
    rel_meas: torch.Tensor        # [F,7] measured T_a_b
    rel_keys: torch.Tensor        # [F,2] int32 (key_a, key_b)
    rel_sqrt_info: torch.Tensor   # [F,6] diagonal sqrt information (1/sigma)
    rel_robust: torch.Tensor      # [F]   bool: Cauchy IRLS weighting
    rel_fixed_a: torch.Tensor     # [F]   bool: key_a held constant
    rel_weight: torch.Tensor      # [F]   f32: 1 active, 0 inactive/removed
    # Prior factors
    prior_meas: torch.Tensor      # [P,7]
    prior_keys: torch.Tensor      # [P]   int32
    prior_sqrt_info: torch.Tensor # [P,6]
    prior_weight: torch.Tensor    # [P]

    @property
    def rel_capacity(self) -> int:
        return self.rel_meas.shape[-2]

    @property
    def prior_capacity(self) -> int:
        return self.prior_meas.shape[-2]
