"""ICP's GN stage (``ops/icp.py`` ``gn_stage``): the plain twin on the CPU
and the two CUDA kernels of ``csrc/icp.cu`` against it on the card.

This file imports only torch, numpy and the port, so it also runs on the
GPU machine (which has no jax), with the repo's conftest left out:

    python3 -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_icp_gn.py

On the CPU (the plain twin against JAX is in ``tests/test_torch_icp.py``):
the stage counts its steps while spans are recorded, none of them fused
on the CPU, CPU tensors of any dtype take the plain twin, and the
kernels' wrappers refuse them.

On the card (``gpu``; here they skip), ``gn_stage_fused`` against
``gn_stage_plain`` on the same inputs, iteration after iteration: T
within 1e-5 of the twin run in float64 on the same inputs (the kernels
sum in f32 in another order and solve in double; torch solves in f32 by
LU, which on a planar, near-degenerate lane lands 2.6e-4 from float64
where the kernels land within 2.4e-6), ``it``, ``done`` and ``n_in``
equal to the twin in float32 and in float64, a lane done at the start
bit-identical; CUDA tensors take the kernels whatever their dtype, so
float64 or mixed-device calls there raise; then whole ICP calls with
shared and per-lane references (T within 1e-5 of the float32 twin's),
bit-equal across repeated calls and across batch sizes, and two launches
a GN step inside every ``icp.gn`` span.
"""

import numpy as np
import pytest
import torch

from laser_slam_tpu_torch.config import IcpConfig
from laser_slam_tpu_torch.core import benchmarker as bench
from laser_slam_tpu_torch.ops import cloud as pc
from laser_slam_tpu_torch.ops import icp as ticp
from laser_slam_tpu_torch.ops import se3
from laser_slam_tpu_torch.parallel import fleet

torch.set_num_threads(2)
T_ATOL = 1e-5


def room_lane(g, N, planar=False):
    """One lane's GN inputs: q on the five faces of a 10 x 8 x 4 m room
    (or the floor alone, with normals tilted by ~1e-3: a planar, nearly
    degenerate lane) with their normals, and a reading that a small
    motion and 5 mm of noise take away from q."""
    q = g.uniform([-5.0, -4.0, 0.0], [5.0, 4.0, 4.0], size=(N, 3))
    face = np.zeros(N, np.int64) if planar else g.integers(0, 5, N)
    axis = np.array([2, 0, 0, 1, 1])[face]
    value = np.array([0.0, -5.0, 5.0, -4.0, 4.0])[face]
    q[np.arange(N), axis] = value
    n = np.zeros((N, 3))
    n[np.arange(N), axis] = 1.0
    if planar:
        n += g.normal(size=(N, 3)) * 1e-3
        n /= np.linalg.norm(n, axis=1, keepdims=True)
    xi = np.concatenate([g.normal(size=3) * 0.02, g.normal(size=3) * 0.1])
    T_true = se3.exp(torch.tensor(xi, dtype=torch.float64))
    pts = se3.apply(se3.inverse(T_true), torch.tensor(q))
    pts = pts.numpy() + g.normal(size=(N, 3)) * 0.005
    return pts, q, n


def stage_scene(lanes, N, seed, planar=(), few=(), done=()):
    """GN-stage inputs for ``lanes`` lanes (None: no lane axis) of N
    points: (points, q, n, inlier, state).  Lanes in ``planar`` are
    planar, those in ``few`` keep 20 inliers (fewer than MIN_INLIERS),
    those in ``done`` start done with a state of their own; the others
    start at the identity with 90% of their points inliers."""
    g = np.random.default_rng(seed)
    B = 1 if lanes is None else lanes
    rows = [room_lane(g, N, planar=b in planar) for b in range(B)]
    pts, q, n = (np.stack([r[k] for r in rows]).astype(np.float32)
                 for k in range(3))
    inlier = g.uniform(size=(B, N)) < 0.9
    smooth = IcpConfig().smooth_length
    T = np.tile(np.array([1.0, 0, 0, 0, 0, 0, 0], np.float32), (B, 1))
    it = np.zeros(B, np.int32)
    hist = np.full((B, smooth, 2), np.inf, np.float32)
    done_ = np.zeros(B, bool)
    err = np.full(B, np.inf, np.float32)
    n_in = np.zeros(B, np.int32)
    for b in few:
        inlier[b] = False
        inlier[b, g.choice(N, 20, replace=False)] = True
    for b in done:
        xi = g.normal(size=6).astype(np.float32) * 0.05
        T[b] = se3.exp(torch.tensor(xi)).numpy()
        it[b], done_[b], err[b], n_in[b] = 3, True, 0.0123, 4321
        hist[b] = g.uniform(size=(smooth, 2)).astype(np.float32) * 1e-3
    state = (T, it, hist, done_, err, n_in)
    if lanes is None:
        pts, q, n, inlier = pts[0], q[0], n[0], inlier[0]
        state = tuple(a[0] for a in state)
    return ([torch.tensor(a) for a in (pts, q, n, inlier)],
            ticp.GnState(*(torch.tensor(a) for a in state)))


def split(a, cut):
    """``a``'s point axis (its last but one, or its last for a mask) in
    two parts at ``cut``."""
    axis = a.dim() - (1 if a.dtype == torch.bool else 2)
    return [a.narrow(axis, 0, cut),
            a.narrow(axis, cut, a.shape[axis] - cut)]


def stage_args(arrays, parts, device):
    """(points, pairs, inliers, n_new) of ``gn_stage`` for the scene's
    arrays cut into ``parts`` shards on ``device``."""
    pts, q, n, inlier = (a.to(device) for a in arrays)
    cut = pts.shape[-2] // 2
    pieces = ([split(a, cut) for a in (pts, q, n, inlier)] if parts == 2
              else [[a] for a in (pts, q, n, inlier)])
    points, qs, ns, inliers = pieces
    n_new = torch.sum(inlier, dim=-1).to(torch.int32)
    return points, list(zip(qs, ns)), inliers, n_new


# --------------------------------------------------------------------------
# CPU: the plain twin
# --------------------------------------------------------------------------

def test_gn_stage_counts_its_steps_on_the_cpu():
    """While spans are recorded, every GN step counts as
    ``icp.gn.steps``; on the CPU none counts as fused.  Off, nothing."""
    arrays, state = stage_scene(lanes=2, N=300, seed=2)
    points, pairs, inliers, n_new = stage_args(arrays, 1, 'cpu')
    cfg = IcpConfig(gn_steps_per_match=3)
    bench.take_counters()
    ticp.gn_stage(points, pairs, inliers, n_new, state, 8, cfg, False)
    assert bench.take_counters() == {}
    with bench.record_spans():
        for _ in range(2):
            state = ticp.gn_stage(points, pairs, inliers, n_new, state, 8,
                                  cfg, False)
    assert bench.take_counters() == {'icp.gn.steps': 6,
                                     'icp.gn.steps_fused': 0}
    bench.take_spans()


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_gn_path_falls_back_for_cpu_and_other_dtypes(dtype):
    """CPU tensors take the plain twin whatever their dtype, and the
    wrappers of the kernels refuse them rather than fall back."""
    arrays, state = stage_scene(lanes=2, N=64, seed=3)
    points = [arrays[0].to(dtype)]
    assert not ticp.gn_fused_path(state.T.to(dtype), points)
    with pytest.raises(ValueError):
        ticp.gn_sums(points[0], arrays[1].to(dtype), arrays[2].to(dtype),
                     arrays[3], state.T.to(dtype))


def test_icp_runs_the_plain_twin_on_the_cpu():
    """A whole ICP call on the CPU counts one GN step an executed
    iteration, none fused (``gn_steps_per_match`` 2: two a match)."""
    arrays, _ = stage_scene(lanes=None, N=512, seed=4)
    pts, q, n, _ = arrays
    cfg = IcpConfig(matcher='brute', reading_capacity=512,
                    reading_sampling_ratio=1.0, gn_steps_per_match=2)
    with bench.record_spans():
        res = ticp.icp_point_to_plane(
            pc.Cloud(pts, torch.ones(512, dtype=torch.bool)),
            pc.Cloud(q, torch.ones(512, dtype=torch.bool)), n,
            se3.identity(), cfg)
    spans = [s for s in bench.take_spans() if s.name == 'icp.gn']
    assert bool(res.valid)
    assert bench.take_counters() == {'icp.gn.steps': 2 * len(spans),
                                     'icp.gn.steps_fused': 0}


# --------------------------------------------------------------------------
# The card: the kernels against the plain twin
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def widen(a):
    return a.double() if a.dtype == torch.float32 else a


def fused_and_plain(arrays, state, parts, S, card, iterations=6,
                    max_iterations=8):
    """The states of the kernels, of the plain twin and of the plain twin
    in float64 (the same inputs widened) after each of ``iterations`` GN
    stages (the kernels with the reading in ``parts`` shards on one card,
    the twins in one part)."""
    cfg = IcpConfig(gn_steps_per_match=S)
    fused_args = stage_args(arrays, parts, card)
    twins = [(stage_args(arrays, 1, card),
              ticp.GnState(*(a.to(card) for a in state))),
             (stage_args([widen(a) for a in arrays], 1, card),
              ticp.GnState(*(widen(a.to(card)) for a in state)))]
    fused = ticp.GnState(*(a.to(card).clone() for a in state))
    assert ticp.gn_fused_path(fused.T, fused_args[0])
    out = []
    for _ in range(iterations):
        fused = ticp.gn_stage(*fused_args, fused, max_iterations, cfg, True)
        twins = [(args, ticp.gn_stage(*args, st, max_iterations, cfg, False))
                 for args, st in twins]
        out.append((ticp.GnState(*(a.clone() for a in fused)),
                    *(st for _, st in twins)))
    torch.cuda.synchronize()
    return out


def assert_states_close(fused, plain, wide, msg=''):
    """T within 1e-5 of the float64 twin (the float32 twin's LU loses
    2.6e-4 on the planar lanes, whose damped systems have condition
    numbers near 2.4e6); it, done and n_in equal to both twins."""
    torch.testing.assert_close(fused.T.double(), wide.T, atol=T_ATOL,
                               rtol=0, msg=f'T, {msg}')
    for field in ('it', 'done', 'n_in'):
        for twin in (plain, wide):
            assert torch.equal(getattr(fused, field),
                               getattr(twin, field)), (field, msg)


@pytest.mark.gpu
@pytest.mark.parametrize('S', [1, 4])
@pytest.mark.parametrize('name,lanes,N,parts,special', [
    ('no-lane', None, 2048, 1, {}),
    ('one-lane', 1, 2048, 1, {}),
    ('64-lanes', 64, 4096, 1, dict(few=(5,), done=(9, 40), planar=(17,))),
    ('ragged', 6, 3001, 1, dict(done=(2,))),
    ('planar', 2, 2500, 1, dict(planar=(0, 1))),
    ('shards', 5, 3000, 2, dict(few=(4,), done=(0,))),
])
def test_gn_kernels_match_the_plain_twin_on_card(card, S, name, lanes, N,
                                                 parts, special):
    """Six GN stages on fixed correspondences: after each the states
    agree as :func:`assert_states_close` says; lanes done at the start
    come back bit-identical and lanes short of inliers end done at
    their (renormalized) start."""
    arrays, state = stage_scene(lanes, N, seed=21, **special)
    for k, (fused, plain, wide) in enumerate(
            fused_and_plain(arrays, state, parts, S, card)):
        assert_states_close(fused, plain, wide, f'{name} after stage {k}')
        for b in special.get('done', ()):
            for field, a, a0 in zip(ticp.GnState._fields, fused, state):
                assert torch.equal(a[b].cpu(), a0[b]), (field, b)
        for b in special.get('few', ()):
            assert bool(fused.done[b]) and int(fused.it[b]) == 0
    # Planar lanes creep along their damped, near-degenerate directions
    # and may still be running; every other lane has converged.
    lanes_ = range(fused.T.reshape(-1, 7).shape[0])
    done_ = fused.done.reshape(-1)
    assert all(bool(done_[b]) for b in lanes_
               if b not in special.get('planar', ()))
    fitted = [b for b in lanes_ if b not in special.get('few', ())]
    assert float(fused.mean_err.reshape(-1)[fitted].max()) < 0.02


@pytest.mark.gpu
def test_gn_kernels_are_bit_equal_across_calls_and_batches_on_card(card):
    """Two runs of the stage are bit-equal, and lane b alone equals lane
    b of the 64-lane batch bit for bit (the chunk count depends on N
    alone)."""
    arrays, state = stage_scene(64, 3000, seed=5, few=(3,), done=(7,))
    runs = [fused_and_plain(arrays, state, 1, 1, card)[-1][0]
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for b in (0, 7, 63):
        alone = fused_and_plain([a[b:b + 1] for a in arrays],
                                ticp.GnState(*(a[b:b + 1] for a in state)),
                                1, 1, card)[-1][0]
        for field, x, y in zip(ticp.GnState._fields, alone, runs[0]):
            assert torch.equal(x[0], y[b]), (field, b)


@pytest.mark.gpu
def test_gn_path_choice_on_card(card):
    """The path follows the device alone: CUDA tensors take the kernels,
    which refuse float64 and a part left on the CPU (ValueError) rather
    than fall back to the plain twin."""
    arrays, state = stage_scene(2, 64, seed=3)
    cfg = IcpConfig()
    for dtype, parts in ((torch.float32, 1), (torch.float64, 1),
                         (torch.float32, 2)):
        args = stage_args([a.to(dtype) if a.is_floating_point() else a
                           for a in arrays], parts, card)
        st = ticp.GnState(*(a.to(card, dtype) if a.is_floating_point()
                            else a.to(card) for a in state))
        if parts == 2:                    # the second part on the CPU
            args[0][1], args[2][1] = args[0][1].cpu(), args[2][1].cpu()
            args[1][1] = tuple(a.cpu() for a in args[1][1])
        assert ticp.gn_fused_path(st.T, args[0])
        if dtype == torch.float32 and parts == 1:
            ticp.gn_stage(*args, st, 8, cfg, True)
        else:
            with pytest.raises(ValueError):
                ticp.gn_stage(*args, st, 8, cfg, True)


def icp_scene(lanes, N, R, seed):
    """Readings [lanes, N, 3] of one room (and per-lane rooms) with
    guesses near the truth."""
    g = np.random.default_rng(seed)
    refs, reads = [], []
    for _ in range(lanes):
        pts, q, _ = room_lane(g, R)
        refs.append(q.astype(np.float32))
        reads.append(pts[g.choice(R, N, replace=False)].astype(np.float32))
    return np.stack(reads), np.stack(refs)


def plain_icp(monkeypatch, fn):
    """``fn()`` with the GN stage forced onto the plain twin."""
    with monkeypatch.context() as m:
        m.setattr(ticp, 'gn_fused_path', lambda T, points: False)
        return fn()


@pytest.mark.gpu
@pytest.mark.parametrize('reference', ['shared', 'per-lane'])
def test_icp_with_the_kernels_matches_the_plain_twin_on_card(
        card, monkeypatch, reference):
    """Whole ICP calls (K2 or K2L, the trim, the GN kernels) against the
    same calls with the plain twin: T within 1e-5, iterations, validity
    and inlier counts equal."""
    B, N, R = 8, 2000, 6000
    reads, refs = icp_scene(B, N, R, seed=31)
    cfg = IcpConfig(matcher='pallas', reading_capacity=N,
                    reading_sampling_ratio=1.0, max_iterations=20)
    pts = torch.tensor(reads, device=card)
    msk = torch.ones((B, N), dtype=torch.bool, device=card)
    guess = se3.identity(device=card).expand(B, 7)
    if reference == 'shared':
        ref = pc.Cloud(torch.tensor(refs[0], device=card),
                       torch.ones(R, dtype=torch.bool, device=card))
        normals = pc.estimate_normals(ref, 10)
        pts = torch.tensor(np.broadcast_to(reads[:1], reads.shape).copy(),
                           device=card) + 0.01 * torch.arange(
                               B, device=card)[:, None, None]
    else:
        ref = pc.Cloud(torch.tensor(refs, device=card),
                       torch.ones((B, R), dtype=torch.bool, device=card))
        normals = torch.stack([pc.estimate_normals(
            pc.Cloud(ref.points[b], ref.mask[b]), 10) for b in range(B)])

    def call():
        return ticp.icp_point_to_plane(pc.Cloud(pts, msk), ref, normals,
                                       guess, cfg)
    fused = call()
    plain = plain_icp(monkeypatch, call)
    torch.testing.assert_close(fused.T, plain.T, atol=T_ATOL, rtol=0)
    for field in ('valid', 'iterations', 'num_inliers'):
        assert torch.equal(getattr(fused, field), getattr(plain, field)), (
            field)
    assert bool(fused.valid.all())


@pytest.mark.gpu
def test_batched_icp_lane_alone_equals_its_lane_in_64_on_card(card):
    """``batched_icp`` over 64 lanes: two calls bit-equal, a lane alone
    (and without a lane axis) bit-equal to its lane in the batch, and
    the 64 lanes bit-equal to two calls of 32."""
    reads, refs = icp_scene(1, 1500, 8000, seed=41)
    g = torch.Generator(device='cpu').manual_seed(3)
    pts = (torch.tensor(reads[0])[None] + 0.02 * torch.randn(
        (64, 1, 3), generator=g)).to(card)
    msk = torch.ones((64, 1500), dtype=torch.bool, device=card)
    msk[5, ::3] = False
    ref = pc.Cloud(torch.tensor(refs[0], device=card),
                   torch.ones(8000, dtype=torch.bool, device=card))
    normals = pc.estimate_normals(ref, 10)
    guesses = se3.identity(device=card).expand(64, 7).contiguous()
    cfg = IcpConfig(matcher='pallas', reading_capacity=1500,
                    reading_sampling_ratio=1.0, max_iterations=12)
    whole = fleet.batched_icp(pts, msk, ref, normals, guesses, cfg)
    again = fleet.batched_icp(pts, msk, ref, normals, guesses, cfg)
    halves = [fleet.batched_icp(pts[s], msk[s], ref, normals, guesses[s],
                                cfg) for s in (slice(0, 32), slice(32, 64))]
    for field, a, b in zip(whole._fields, whole, again):
        assert torch.equal(a, b), field
        assert torch.equal(a, torch.cat([getattr(h, field)
                                         for h in halves])), field
    for b in (0, 5, 63):
        lane = fleet.batched_icp(pts[b:b + 1], msk[b:b + 1], ref, normals,
                                 guesses[b:b + 1], cfg)
        single = ticp.icp_point_to_plane(pc.Cloud(pts[b], msk[b]), ref,
                                         normals, guesses[b], cfg)
        for field, a, x, y in zip(whole._fields, whole, lane, single):
            assert torch.equal(x[0], a[b]) and torch.equal(y, a[b]), (
                field, b)


@pytest.mark.gpu
@pytest.mark.parametrize('S', [1, 4])
def test_gn_span_issues_two_launches_a_step_on_card(card, S):
    """Under the device profiler, the runtime launches issued inside each
    ``icp.gn`` span are exactly 2 a GN step, and the counters count every
    step as fused."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B, N, R = 4, 1024, 4096
    reads, refs = icp_scene(B, N, R, seed=51)
    ref = pc.Cloud(torch.tensor(refs, device=card),
                   torch.ones((B, R), dtype=torch.bool, device=card))
    normals = torch.stack([pc.estimate_normals(
        pc.Cloud(ref.points[b], ref.mask[b]), 10) for b in range(B)])
    pts = torch.tensor(reads, device=card)
    msk = torch.ones((B, N), dtype=torch.bool, device=card)
    guess = se3.identity(device=card).expand(B, 7)
    cfg = IcpConfig(matcher='pallas', reading_capacity=N,
                    reading_sampling_ratio=1.0, max_iterations=6,
                    gn_steps_per_match=S)

    def call():
        return ticp.icp_point_to_plane(pc.Cloud(pts, msk), ref, normals,
                                       guess, cfg)
    call()                                  # builds both libraries
    torch.cuda.synchronize()
    bench.take_spans()
    bench.take_counters()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with bench.record_spans():
            call()
        torch.cuda.synchronize()
    spans = [s for s in bench.take_spans() if s.name == 'icp.gn']
    counts = bench.take_counters()
    assert len(spans) == cfg.max_iterations
    assert counts['icp.gn.steps'] == counts['icp.gn.steps_fused'] == (
        S * cfg.max_iterations)
    events = list(prof.profiler.kineto_results.events())
    device = {e.correlation_id() for e in events
              if e.device_type() == DeviceType.CUDA}
    launches = [e.start_ns() for e in events
                if e.device_type() == DeviceType.CPU
                and e.name().startswith('cu') and e.correlation_id() in device]
    for s in spans:
        inside = [t for t in launches if s.start_ns <= t <= s.end_ns]
        assert len(inside) == 2 * S
