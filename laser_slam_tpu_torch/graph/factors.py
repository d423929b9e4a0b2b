"""Pose-graph factors as fixed-capacity tensors.

Counterpart of ``laser_slam_tpu/graph/factors.py``: the padded graph the
solver reads.  An inactive slot has weight 0, and factor removal is a
weight write, never a reshape.  Relative factors have residual
log(meas^-1 * Ta^-1 * Tb); prior factors log(meas^-1 * T).  Noise models
are diagonal sqrt-information 6-vectors ([rot, trans]).

``HostGraph`` is the host-side factor store of the object API
(``core/estimator.py``); the online path keeps its factors in
``OnlineState``.  ``HostGraph.to_device`` uploads the whole padded graph
for every solve, as the JAX package does, and
``HostGraph.offchain_count`` gives the solver its matvec choice without
a device read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from laser_slam_tpu_torch.ops import se3

# sqrt-info beyond this makes a prior a hard gauge constraint: the solver
# freezes its pose and snaps it to the prior (graph/solver.py).
GAUGE_FIX_THRESHOLD = 1.0e5


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


def empty_graph(rel_capacity: int, prior_capacity: int,
                device='cuda') -> FactorGraphData:
    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    ident = se3.identity(device=device)
    return FactorGraphData(
        rel_meas=ident.expand(rel_capacity, 7).clone(),
        rel_keys=zeros((rel_capacity, 2), torch.int32),
        rel_sqrt_info=zeros((rel_capacity, 6)),
        rel_robust=zeros((rel_capacity,), torch.bool),
        rel_fixed_a=zeros((rel_capacity,), torch.bool),
        rel_weight=zeros((rel_capacity,)),
        prior_meas=ident.expand(prior_capacity, 7).clone(),
        prior_keys=zeros((prior_capacity,), torch.int32),
        prior_sqrt_info=zeros((prior_capacity, 6)),
        prior_weight=zeros((prior_capacity,)),
    )


class HostGraph:
    """Host-side mutable factor store with capacity-doubling numpy arrays.

    The incremental front-end appends factors scan by scan (the reference
    pushes into ``NonlinearFactorGraph``, laser_track.cpp:211-222); this
    class owns the authoritative copy and materializes a
    :class:`FactorGraphData` (padded to the next power-of-two bucket) on
    a device for each solve.
    """

    def __init__(self, rel_capacity: int = 1024, prior_capacity: int = 64):
        self._rel_cap = rel_capacity
        self._prior_cap = prior_capacity
        self.n_rel = 0
        self.n_prior = 0
        self.rel_meas = np.zeros((rel_capacity, 7), np.float32)
        self.rel_meas[:, 0] = 1.0
        self.rel_keys = np.zeros((rel_capacity, 2), np.int32)
        self.rel_sqrt_info = np.zeros((rel_capacity, 6), np.float32)
        self.rel_robust = np.zeros((rel_capacity,), bool)
        self.rel_fixed_a = np.zeros((rel_capacity,), bool)
        self.rel_weight = np.zeros((rel_capacity,), np.float32)
        self.prior_meas = np.zeros((prior_capacity, 7), np.float32)
        self.prior_meas[:, 0] = 1.0
        self.prior_keys = np.zeros((prior_capacity,), np.int32)
        self.prior_sqrt_info = np.zeros((prior_capacity, 6), np.float32)
        self.prior_weight = np.zeros((prior_capacity,), np.float32)

    def _grow_rel(self):
        new_cap = self._rel_cap * 2
        for name in ('rel_meas', 'rel_keys', 'rel_sqrt_info', 'rel_robust',
                     'rel_fixed_a', 'rel_weight'):
            old = getattr(self, name)
            new = np.zeros((new_cap,) + old.shape[1:], old.dtype)
            new[:self._rel_cap] = old
            setattr(self, name, new)
        self.rel_meas[self._rel_cap:, 0] = 1.0
        self._rel_cap = new_cap

    def _grow_prior(self):
        new_cap = self._prior_cap * 2
        for name in ('prior_meas', 'prior_keys', 'prior_sqrt_info',
                     'prior_weight'):
            old = getattr(self, name)
            new = np.zeros((new_cap,) + old.shape[1:], old.dtype)
            new[:self._prior_cap] = old
            setattr(self, name, new)
        self.prior_meas[self._prior_cap:, 0] = 1.0
        self._prior_cap = new_cap

    def add_relative(self, key_a: int, key_b: int, T_a_b, sigmas,
                     robust: bool = False, fixed_a: bool = False) -> int:
        """Append a relative factor; returns its index."""
        if self.n_rel == self._rel_cap:
            self._grow_rel()
        i = self.n_rel
        self.rel_meas[i] = np.asarray(T_a_b, np.float32)
        self.rel_keys[i] = (key_a, key_b)
        self.rel_sqrt_info[i] = 1.0 / np.asarray(sigmas, np.float32)
        self.rel_robust[i] = robust
        self.rel_fixed_a[i] = fixed_a
        self.rel_weight[i] = 1.0
        self.n_rel += 1
        return i

    def add_prior(self, key: int, T_w, sigmas) -> int:
        """Append a prior factor; returns its index (for later removal)."""
        if self.n_prior == self._prior_cap:
            self._grow_prior()
        i = self.n_prior
        self.prior_meas[i] = np.asarray(T_w, np.float32)
        self.prior_keys[i] = key
        self.prior_sqrt_info[i] = 1.0 / np.asarray(sigmas, np.float32)
        self.prior_weight[i] = 1.0
        self.n_prior += 1
        return i

    def remove_prior(self, index: int) -> None:
        """Deactivate a prior factor (the reference's iSAM2
        removeFactorIndices, incremental_estimator.cpp:258)."""
        self.prior_weight[index] = 0.0

    def remove_relative(self, index: int) -> None:
        self.rel_weight[index] = 0.0

    def _bucket(self, n: int, minimum: int) -> int:
        cap = minimum
        while cap < n:
            cap *= 2
        return cap

    def offchain_count(self) -> int:
        """The active relative factors off the solver's block-tridiagonal
        chain: key_b != key_a + 1, or a key frozen by an active gauge
        prior (``solver._offchain_mask`` on any pose mask that covers the
        factors' keys).  Passed to the solver as ``offchain``, it picks
        the matvec without a device read."""
        n, p = self.n_rel, self.n_prior
        keys = self.rel_keys[:n]
        gauge = ((self.prior_weight[:p] > 0)
                 & np.any(self.prior_sqrt_info[:p] > GAUGE_FIX_THRESHOLD,
                          axis=-1))
        frozen = self.prior_keys[:p][gauge]
        off = ((keys[:, 1] != keys[:, 0] + 1)
               | np.isin(keys[:, 0], frozen) | np.isin(keys[:, 1], frozen))
        return int(np.count_nonzero(off & (self.rel_weight[:n] > 0)))

    def to_device(self, rel_bucket_min: int = 256,
                  prior_bucket_min: int = 16,
                  device='cuda') -> FactorGraphData:
        """Materialize the padded graph on ``device`` (bucketed sizes, as
        the JAX package's, which buckets to limit recompiles)."""
        rc = self._bucket(max(self.n_rel, 1), rel_bucket_min)
        pcap = self._bucket(max(self.n_prior, 1), prior_bucket_min)

        def up(a):
            return torch.from_numpy(a).to(device)

        return FactorGraphData(
            rel_meas=up(self.rel_meas[:rc]),
            rel_keys=up(self.rel_keys[:rc]),
            rel_sqrt_info=up(self.rel_sqrt_info[:rc]),
            rel_robust=up(self.rel_robust[:rc]),
            rel_fixed_a=up(self.rel_fixed_a[:rc]),
            rel_weight=up(self.rel_weight[:rc]),
            prior_meas=up(self.prior_meas[:pcap]),
            prior_keys=up(self.prior_keys[:pcap]),
            prior_sqrt_info=up(self.prior_sqrt_info[:pcap]),
            prior_weight=up(self.prior_weight[:pcap]),
        )


# ---------------------------------------------------------------------------
# Lanes: B graphs of one shape (the fleet, parallel/fleet.py)
# ---------------------------------------------------------------------------

def lane_graph(graphs: FactorGraphData, b: int) -> FactorGraphData:
    """Lane b of a lane-axis graph."""
    return FactorGraphData(*(leaf[b] for leaf in graphs))


def join_lanes(graphs: FactorGraphData, n_poses: int) -> FactorGraphData:
    """One graph over ``B * n_poses`` poses from a lane-axis graph (every
    field [B, ...]): lane b's factors follow lane b-1's, its pose keys
    offset by ``b * n_poses``.  The joined Hessian is block-diagonal
    across lanes, and lane b keeps its factor slots contiguous, so
    per-lane sums are reshapes (graph/solver.py ``lanes``)."""
    B = graphs.rel_meas.shape[0]
    offset = n_poses * torch.arange(B, dtype=torch.int32,
                                    device=graphs.rel_keys.device)

    def flat(a):
        return a.reshape((-1,) + a.shape[2:])

    return FactorGraphData(
        rel_meas=flat(graphs.rel_meas),
        rel_keys=flat(graphs.rel_keys + offset[:, None, None]),
        rel_sqrt_info=flat(graphs.rel_sqrt_info),
        rel_robust=flat(graphs.rel_robust),
        rel_fixed_a=flat(graphs.rel_fixed_a),
        rel_weight=flat(graphs.rel_weight),
        prior_meas=flat(graphs.prior_meas),
        prior_keys=flat(graphs.prior_keys + offset[:, None]),
        prior_sqrt_info=flat(graphs.prior_sqrt_info),
        prior_weight=flat(graphs.prior_weight))


def build_fleet_chain_graphs(rel_meas, rel_valid, first_poses, odo_sigmas,
                             prior_sigma: float = 1e-7):
    """Batched chain graphs from fleet odometry output (the JAX package's
    ``parallel/fleet.py`` function of the same name).

    rel_meas: [B,T,7] ICP relative transforms (entry 0 ignored)
    rel_valid: [B,T] — invalid steps get weight 0 (odometry-only fallback,
        mirroring the reference's convergence-failure semantics)
    first_poses: [B,7] prior measurement per lane
    Returns (FactorGraphData with leading B axis, pose_mask [B,T]).
    """
    B, T, _ = rel_meas.shape
    F = T - 1
    dev = rel_meas.device
    keys = torch.stack([torch.arange(F, device=dev),
                        torch.arange(1, T, device=dev)], dim=-1)
    sigmas = torch.as_tensor(odo_sigmas, dtype=torch.float32, device=dev)
    graphs = FactorGraphData(
        rel_meas=rel_meas[:, 1:],
        rel_keys=keys.to(torch.int32).expand(B, F, 2).contiguous(),
        rel_sqrt_info=(1.0 / sigmas).expand(B, F, 6).contiguous(),
        rel_robust=torch.zeros((B, F), dtype=torch.bool, device=dev),
        rel_fixed_a=torch.zeros((B, F), dtype=torch.bool, device=dev),
        rel_weight=rel_valid[:, 1:].to(torch.float32),
        prior_meas=first_poses[:, None, :],
        prior_keys=torch.zeros((B, 1), dtype=torch.int32, device=dev),
        prior_sqrt_info=torch.full((B, 1, 6), 1.0 / prior_sigma,
                                   dtype=torch.float32, device=dev),
        prior_weight=torch.ones((B, 1), dtype=torch.float32, device=dev),
    )
    pose_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    return graphs, pose_mask
