"""The fleet SLAM step and the pose-graph solve split over a mesh of
devices.

Counterpart of ``laser_slam_tpu/parallel/sharding.py``, which annotates
``jax.jit`` with shardings and lets XLA insert the collectives.  Here one
process drives a :class:`Mesh` of torch devices, and every move and
reduction between devices is an explicit call of this module
(:func:`to_device`, :func:`reduce_sum`, :func:`gather_cat`):

* **dp (fleet/data parallel)**: the fleet's lanes split across devices,
  with no traffic between them during ICP and one batched solve per lane
  group.
* **sp (point/sequence parallel)**: each scan's point axis split across
  devices.  Every shard matches its points against its lane's reference
  (scan t-1, itself split over sp, gathered onto each device first, as
  XLA's all-gather does), and what spans a lane's whole reading is
  reduced over sp: the trim's exact quantile, the 6x6 Gauss-Newton
  sums, the inlier count and the error sum (``ops/icp.
  icp_point_shards``).  The loop state, the odometry and the lane
  group's solve live on the group's first device.
* **gp (graph/factor parallel)**: the pose-graph solve with its factor
  axis split (:func:`sharded_solve`).  Every segment sum onto the pose
  axis is reduced onto the first device, where the poses, the priors
  and the preconditioner stay (``graph/solver.py``, "Factor shards").

A device may repeat in a mesh: eight shards on ``'cpu'`` run the JAX
package's 8-device CPU tests, and eight on ``'cuda:0'`` run every shard's
kernels and reductions on one card.  Shards on one device share one
copy of what is replicated; with a device repeated they also share one
CUDA stream, so their times are no scaling result.  On distinct cards
the same code puts the shards there, and the moves become copies
between cards.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Moves and reductions between devices
# ---------------------------------------------------------------------------

def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device`` (itself when it lies there already); a copy to
    a card does not wait for the host."""
    device = torch.device(device)
    return x.to(device, non_blocking=device.type == 'cuda')


def reduce_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of ``parts`` (one shape, any devices) on ``device``, added
    in order: the reduce half of an all-reduce.  One part comes back as
    it is."""
    total = to_device(parts[0], device)
    for p in parts[1:]:
        total = total + to_device(p, device)
    return total


def gather_cat(parts: Sequence[torch.Tensor], dim: int,
               device) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` on ``device``: an all-gather's
    result on one device.  One part comes back as it is."""
    if len(parts) == 1:
        return to_device(parts[0], device)
    return torch.cat([to_device(p, device) for p in parts], dim=dim)


# ---------------------------------------------------------------------------
# The mesh and sharded tensors
# ---------------------------------------------------------------------------

class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy object
    array of ``torch.device``s shaped (dp, sp) or (gp,); ``shape`` maps
    each axis name to its size, as JAX's ``mesh.shape`` does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f'Mesh: {devices.ndim} device axes, axis names '
                             f'{self.axis_names}')

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self):
        return f'Mesh({self.shape}, {list(self.devices.flat)})'


def _devices(devices) -> list:
    """``devices`` as torch.devices (a card's index resolved), or every
    visible card; raises when there is none, so a mesh runs on the CPU
    only when the caller names the CPU."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                'make_mesh: no CUDA device is visible; pass devices='
                "['cpu'] * n for a mesh on the CPU")
        return [torch.device('cuda', i) for i in range(count)]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == 'cuda' and d.index is None:
            d = torch.device('cuda', torch.cuda.current_device())
        out.append(d)
    return out


def _grid(devices: list, shape: tuple) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return grid.reshape(shape)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              sp: Optional[int] = None, devices=None) -> Mesh:
    """A (dp, sp) mesh over the first ``n_devices`` of ``devices`` (every
    visible card by default; a device may repeat).

    Default split (unless both ``dp`` and ``sp`` are given): sp = 2
    point shards when the device count is even and above 1, and as many
    fleet (dp) shards as that leaves."""
    devices = _devices(devices)
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f'make_mesh: {n} devices asked, {len(devices)} '
                         'given')
    devices = devices[:n]
    if dp is None or sp is None:
        sp = 2 if n % 2 == 0 and n > 1 else 1
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f'make_mesh: dp {dp} x sp {sp} is not {n} devices')
    return Mesh(_grid(devices, (dp, sp)), ('dp', 'sp'))


def make_graph_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the 'gp' (graph/factor parallel) axis."""
    devices = _devices(devices)
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f'make_graph_mesh: {n} devices asked, '
                         f'{len(devices)} given')
    return Mesh(_grid(devices[:n], (n,)), ('gp',))


class Sharded(NamedTuple):
    """A tensor laid out over a mesh.  ``spec`` names, for each leading
    dimension, the mesh axis it is split over or None (JAX's
    ``PartitionSpec``; dimensions past it are whole); on the mesh axes
    that ``spec`` does not name the blocks are replicated.
    ``shards[idx]`` is the block on ``mesh.devices[idx]``."""
    mesh: Mesh
    spec: tuple
    shards: np.ndarray

    def gather(self, device) -> torch.Tensor:
        """The global tensor on ``device``: the blocks concatenated in
        mesh order, each replicated block taken once."""
        names = self.mesh.axis_names
        split = [(d, a) for d, a in enumerate(self.spec) if a is not None]

        def build(k, index):
            if k == len(split):
                return to_device(self.shards[tuple(index.get(a, 0)
                                                   for a in names)], device)
            d, a = split[k]
            return gather_cat([build(k + 1, {**index, a: i})
                               for i in range(self.mesh.shape[a])], d,
                              device)

        return build(0, {})


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.array(x))


def put(mesh: Mesh, x, spec: tuple) -> Sharded:
    """``x`` (a tensor or an array) laid out over ``mesh`` as ``spec``
    says (:class:`Sharded`); a :class:`Sharded` of that layout comes back
    as it is.  A dimension that its mesh axis does not divide raises a
    ValueError naming the axis.  Blocks that land on one device with the
    same contents are one tensor."""
    spec = tuple(spec)
    if isinstance(x, Sharded):
        if x.mesh is mesh and x.spec == spec:
            return x
        raise ValueError(f'put: a tensor sharded as {x.spec} on another '
                         f'mesh, not {spec}')
    x = _as_tensor(x)
    names = mesh.axis_names
    if len(spec) > x.dim():
        raise ValueError(f'put: spec {spec} for a {x.dim()}-d tensor')
    for d, a in enumerate(spec):
        if a is None:
            continue
        if a not in names:
            raise ValueError(f'put: no mesh axis {a!r} in {names}')
        if x.shape[d] % mesh.shape[a]:
            raise ValueError(
                f"put: dimension {d} of size {x.shape[d]} does not divide "
                f"by mesh axis {a!r} of size {mesh.shape[a]}")
    shards = np.empty(mesh.devices.shape, dtype=object)
    made = {}
    for idx in np.ndindex(*mesh.devices.shape):
        device = mesh.devices[idx]
        block = []
        for d, a in enumerate(spec):
            if a is None:
                block.append(slice(None))
            else:
                i = idx[names.index(a)]
                m = x.shape[d] // mesh.shape[a]
                block.append(slice(i * m, (i + 1) * m))
        key = (device, tuple((s.start, s.stop) for s in block))
        if key not in made:
            made[key] = to_device(x[tuple(block)], device).contiguous()
        shards[idx] = made[key]
    return Sharded(mesh, spec, shards)


def replicate(mesh: Mesh, x: torch.Tensor) -> Sharded:
    """``x`` on every device of ``mesh``."""
    return put(mesh, x, ())


# ---------------------------------------------------------------------------
# The fleet SLAM step over (dp, sp)
# ---------------------------------------------------------------------------

POINTS_SPEC = ('dp', None, 'sp', None)      # points, normals [B,T,N,3]
MASKS_SPEC = ('dp', None, 'sp')              # masks [B,T,N]
POSE_SPEC = ('dp', None)                     # init_pose [B,7]
ODOM_SPEC = ('dp', None, None)               # odom_rel [B,T,7]


def shard_fleet_inputs(mesh: Mesh, points, masks, normals, init_pose,
                       odom_rel):
    """The fleet inputs laid out as :func:`fleet_slam_step` reads them:
    lanes over dp, the point axis over sp; ``init_pose`` and ``odom_rel``
    over dp only."""
    return (put(mesh, points, POINTS_SPEC), put(mesh, masks, MASKS_SPEC),
            put(mesh, normals, POINTS_SPEC), put(mesh, init_pose, POSE_SPEC),
            put(mesh, odom_rel, ODOM_SPEC))


def _odometry_sp(points, masks, normals, init_pose, odom_rel, devices,
                 config):
    """``fleet.fleet_icp_odometry`` of one lane group whose point axis is
    split over ``devices`` (its sp shards: ``points[j]`` [b,T,n,3] on
    ``devices[j]``), the odometry on ``devices[0]``."""
    from laser_slam_tpu_torch.ops import cloud as pc
    from laser_slam_tpu_torch.ops import icp as icp_mod
    from laser_slam_tpu_torch.parallel import fleet
    distinct = list(dict.fromkeys(devices))

    def register(t):
        # Scan t-1, the reference, gathered whole onto each device of the
        # group, with one matcher a device: K2L's tables are built once
        # for the shards that share a device.
        matchers = {}
        for d in distinct:
            ref = pc.Cloud(gather_cat([p[:, t - 1] for p in points], 1, d),
                           gather_cat([m[:, t - 1] for m in masks], 1, d))
            matchers[d] = icp_mod.make_matcher(
                ref, gather_cat([n[:, t - 1] for n in normals], 1, d),
                config)
        return icp_mod.icp_point_shards(
            [pc.Cloud(p[:, t], m[:, t]) for p, m in zip(points, masks)],
            [matchers[d] for d in devices], odom_rel[:, t], config)

    return fleet.chain_odometry(register, init_pose, points[0].shape[1])


def fleet_slam_step(mesh: Mesh, icp_config, solver_config):
    """The full fleet SLAM step (ICP odometry chain + batched pose-graph
    solve) over ``mesh``.

    Returns ``step(points[B,T,N,3], masks, normals, init_pose[B,7],
    odom_rel[B,T,7], odo_sigmas[6]) -> (poses, solve_result)``: inputs
    as tensors, arrays or :func:`shard_fleet_inputs`'s layout; lanes
    split over dp and point axes over sp; each lane group registered
    with its sp reductions (``icp.icp_point_shards``), its chain graphs
    built (``factors.build_fleet_chain_graphs``) and solved
    (``fleet.fleet_solve``) on its first device, with no traffic between
    groups.  ``poses`` [B,T,7] and the fields of ``solve_result``
    (``solver.SolveResult``) are :class:`Sharded` over dp, replicated
    over sp.  Nothing is read to the host on the card (on the CPU, ICP
    stops where JAX's loop stops).
    """
    from laser_slam_tpu_torch.graph import solver as sv
    from laser_slam_tpu_torch.parallel import fleet

    def step(points, masks, normals, init_pose, odom_rel, odo_sigmas):
        points, masks, normals, init_pose, odom_rel = shard_fleet_inputs(
            mesh, points, masks, normals, init_pose, odom_rel)
        if isinstance(odo_sigmas, Sharded):
            odo_sigmas = odo_sigmas.shards.flat[0]
        dp, sp = mesh.devices.shape
        fields = [np.empty((dp, sp), dtype=object) for _ in range(4)]
        for i in range(dp):
            devices = list(mesh.devices[i])
            odo = _odometry_sp(
                [points.shards[i, j] for j in range(sp)],
                [masks.shards[i, j] for j in range(sp)],
                [normals.shards[i, j] for j in range(sp)],
                init_pose.shards[i, 0], odom_rel.shards[i, 0], devices,
                icp_config)
            graphs, pose_mask = fleet.build_fleet_chain_graphs(
                odo.rel_icp, odo.valid, init_pose.shards[i, 0], odo_sigmas)
            # One off-chain factor a lane (the factor on the gauge-fixed
            # first pose), so the matvec is chosen without a read.
            res = fleet.fleet_solve(graphs, odo.poses, pose_mask,
                                    solver_config, offchain=1)
            lanes = res.poses.shape[:1]
            for k, x in enumerate(res):
                if k:
                    x = x.reshape(lanes)     # one lane's comes back 0-d
                for j, d in enumerate(devices):
                    fields[k][i, j] = to_device(x, d)
        poses = Sharded(mesh, ('dp', None, None), fields[0])
        rest = [Sharded(mesh, ('dp',), f) for f in fields[1:]]
        return poses, sv.SolveResult(poses, *rest)

    return step


# ---------------------------------------------------------------------------
# The factor-sharded pose-graph solve over gp
# ---------------------------------------------------------------------------

def _graph_spec(name: str) -> tuple:
    return ('gp',) if name.startswith('rel_') else ()


def shard_graph_inputs(mesh: Mesh, graph, poses, pose_mask):
    """The solve's inputs laid out as :func:`sharded_solve` reads them:
    the ``rel_*`` fields split over gp, the priors, poses and mask
    replicated."""
    graph = type(graph)(**{name: put(mesh, leaf, _graph_spec(name))
                           for name, leaf in graph._asdict().items()})
    return graph, replicate(mesh, poses), replicate(mesh, pose_mask)


def factor_shards(mesh: Mesh, graph, poses, pose_mask):
    """The solver's view of :func:`shard_graph_inputs`'s layout (tensors
    are laid out first): a ``factors.FactorShards`` graph, one part a
    device, the priors once, in the first part; and the poses and mask
    on the first device."""
    from laser_slam_tpu_torch.graph.factors import FactorShards
    graph, poses, pose_mask = shard_graph_inputs(mesh, graph, poses,
                                                 pose_mask)
    parts = tuple(type(graph)(**{
        name: (leaf.shards[i] if name.startswith('rel_') or i == 0
               else leaf.shards[i][:0])
        for name, leaf in graph._asdict().items()})
        for i in range(mesh.size))
    return FactorShards(parts), poses.shards[0], pose_mask.shards[0]


def sharded_solve(mesh: Mesh, solver_config):
    """The pose-graph solve with its FACTOR axis split over the 'gp'
    mesh.

    The relative-factor arrays (the dominant data, and the dominant
    linearize and matvec work: one 6x6 block pair a factor) are split
    over the mesh; the pose table, the priors, the mask and the
    preconditioner stay on the first device.  Each device linearizes its
    factors and sums them onto the pose axis; those sums (J^T W J x in
    the matvec, J^T W r, the preconditioner's blocks, the error) are
    reduced onto the first device, 6N floats a reduction, where PCG's
    dot products and the preconditioner's factor and apply run once
    (``graph/solver.py``, "Factor shards").  A device then holds 1/gp of
    the factors, which frees the graph's size from one card's memory.

    Returns ``solve(graph, poses, pose_mask) -> SolveResult``: inputs as
    tensors or :func:`shard_graph_inputs`'s layout, every output field
    :class:`Sharded` and replicated.
    """
    from laser_slam_tpu_torch.graph import solver as sv

    def solve(graph, poses, pose_mask):
        res = sv.solve(*factor_shards(mesh, graph, poses, pose_mask),
                       solver_config)
        return sv.SolveResult(*(replicate(mesh, x) for x in res))

    return solve
