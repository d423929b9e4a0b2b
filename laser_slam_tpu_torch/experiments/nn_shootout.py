"""The exact-NN kernel shootout on the card.

Counterpart of ``experiments/pallas_nn_bench.py``,
``experiments/pallas_nn_variants.py`` and
``experiments/pallas_tile_sweep.py``: every exact-NN variant at the ICP
correspondence shape, 8192 queries against 65536 reference points with a
``[point | unit normal]`` payload (6 f32), the scene of those scripts
(``numpy.random.default_rng(3)``: reference uniform in a 100 m cube,
queries 5 cm from reference points).  Each variant is timed by CUDA
events (mean over ``reps`` launches after a warm-up) beside the one
PyTorch call that computes the same function, where there is one.

Rows: ``brute`` (plain ``nn_brute`` plus the payload gather), ``payload``
(E4, with its work items a launch), ``pruned`` (E6 with its set-up, with the share of reference tiles
its kernel scans),
``indices`` (K1 plus the gather), ``idx-kernel`` (K1), ``indices-hi``
(E5, E1 at ``highest``, with its work items), ``indices-bf16`` (E1 at
one bf16 pass, with its work items, its max |d2 - exact| and the
library call's largest d2 gap to it), ``vpu`` (E2) and the tile sweep
(E3, with its work items a launch).

Run on a machine with a CUDA card:

    python -m laser_slam_tpu_torch.experiments.nn_shootout

It prints one line per row and, last, the rows as one JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from laser_slam_tpu_torch.ops import nn_kernels as nk
from laser_slam_tpu_torch.ops import nn_variants as nv
from laser_slam_tpu_torch.ops.neighbors import nn_brute

N_QUERIES = 8192
N_REFS = 65536
# (query tile, reference tile) of pallas_tile_sweep.py:83-84.
SWEEP = ((128, 2048), (256, 1024), (256, 4096), (512, 2048), (512, 4096),
         (1024, 2048), (128, 8192), (8192, 65536))


def make_scene(n_queries: int = N_QUERIES, n_refs: int = N_REFS,
               seed: int = 3):
    """(queries [Q,3], reference [R,3], payload [R,6]) f32 numpy arrays,
    drawn in the order of pallas_nn_bench.py:45-50."""
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-50, 50, (n_refs, 3)).astype(np.float32)
    nrm = rng.standard_normal((n_refs, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    queries = (ref[rng.integers(0, n_refs, n_queries)]
               + rng.normal(0, 0.05, (n_queries, 3))).astype(np.float32)
    return queries, ref, np.concatenate([ref, nrm], axis=1)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, one warm-up
    call first)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# The shootout
# --------------------------------------------------------------------------

EXACT_LIBRARY_CALL = ('torch.cdist(compute_mode=donot_use_mm_for_euclid_dist)'
                      '.min(1)')


def exact_library_call(q, r):
    """The one PyTorch call that computes the exact rows' function: the
    shootout's yardstick, which no path of the port calls."""
    return torch.cdist(q, r, compute_mode='donot_use_mm_for_euclid_dist'
                       ).min(1)


BF16_LIBRARY_CALL = ('torch.mm(q_ext8.bfloat16(), r_ext8.bfloat16().T, '
                     'out_dtype=torch.float32).min(1)')


def bf16_library_call(q_ext8, r_ext8):
    """The one PyTorch call that computes E1's scores (one bf16 pass with
    f32 output) and their least, on the extended rows padded to 8 columns
    with zeros and rounded to bf16 ([Q,8], [R,8], as the Pallas
    ``q_ext``/``r_ext``): E1's yardstick, which no path of the port
    calls."""
    return torch.mm(q_ext8, r_ext8.T, out_dtype=torch.float32).min(1)


def run(queries: torch.Tensor, ref_points: torch.Tensor,
        payload: torch.Tensor, reps: int = 20, log=print) -> list:
    """Time every variant on CUDA tensors; returns one dict per row with
    ``name``, ``ms``, ``library_ms`` (None where no single call computes
    the function, with the reason in ``library``), ``max_d2_err`` against
    the exact plain brute force and row-specific extras."""
    if not queries.is_cuda:
        raise ValueError('the shootout runs on the card (CUDA tensors)')
    Q, R = queries.shape[0], ref_points.shape[0]
    exact_d2 = nn_brute(queries, ref_points)[1]
    q_ext = nv.extend_queries(queries)
    r_ext = nv.extend_reference(ref_points)
    exact_call = EXACT_LIBRARY_CALL
    # cdist's direct (non-matmul) path takes most of a second here: a few
    # launches are enough.
    lib_exact = cuda_ms(lambda: exact_library_call(queries, ref_points), 2)
    lib_mm = cuda_ms(lambda: nv._f32_matmul(q_ext, r_ext.T).min(1), reps)
    q8 = torch.nn.functional.pad(q_ext, (0, 4)).to(torch.bfloat16)
    r8 = torch.nn.functional.pad(r_ext, (0, 4)).to(torch.bfloat16)
    try:
        lib_bf16 = cuda_ms(lambda: bf16_library_call(q8, r8), reps)
        bf16_call = BF16_LIBRARY_CALL
        lib_d2 = torch.clamp(bf16_library_call(q8, r8).values
                             + nv.query_norm2(queries), min=0.0)
    except (RuntimeError, TypeError, NotImplementedError) as exc:
        lib_bf16, lib_d2 = None, None
        bf16_call = f'refused here: {BF16_LIBRARY_CALL}: {exc}'[:400]
    no_payload_call = ('none: no PyTorch call averages the payloads of '
                       'tied rows')
    rows = []

    def row(name, fn, d2_of, lib_ms, library, **extra):
        d2 = d2_of(fn())
        torch.cuda.synchronize()
        rec = dict(name=name, ms=cuda_ms(fn, reps), library_ms=lib_ms,
                   library=library,
                   max_d2_err=float(torch.max(torch.abs(
                       d2.double() - exact_d2.double()))), **extra)
        rows.append(rec)
        lib = 'n/a' if lib_ms is None else f'{lib_ms:.4f}'
        log(f'{name:14s} {rec["ms"]:9.4f} ms  library {lib:>9s} ms  '
            f'max |d2 - exact| {rec["max_d2_err"]:.3e}'
            + ''.join(f'  {k} {v}' for k, v in extra.items()))
        return rec

    row('brute', lambda: (lambda i_d: (i_d[1], payload[i_d[0].long()]))(
        nn_brute(queries, ref_points)), lambda o: o[0], lib_exact,
        exact_call + ' and a gather', kernel=None)
    row('payload', lambda: nv.nn_payload(queries, ref_points, payload),
        lambda o: o[0], None, no_payload_call, kernel='E4',
        items=nv.mm_items(Q, R))
    visits = nv.nn_payload_pruned(queries, ref_points, payload,
                                  return_visits=True)[2]
    n_tiles = (R // nk._tile(R, nv._RB_PRUNED)) * visits.numel()
    share = float(visits.sum()) / n_tiles
    row('pruned', lambda: nv.nn_payload_pruned(queries, ref_points, payload),
        lambda o: o[0], None, no_payload_call, kernel='E6',
        scanned_share=share)
    row('indices', lambda: (lambda d_i: (d_i[0], payload[d_i[1].long()]))(
        nk.nn_indices(queries, ref_points)), lambda o: o[0], lib_exact,
        exact_call + ' and a gather', kernel='K1')
    row('idx-kernel', lambda: nk.nn_indices(queries, ref_points),
        lambda o: o[0], lib_exact, exact_call, kernel='K1')
    row('indices-hi', lambda: nv.nn_indices_mm(queries, ref_points),
        lambda o: o[0], lib_mm,
        'torch.matmul of the extended rows (TF32 off) and .min(1)',
        kernel='E5', items=nv.mm_items(Q, R))
    e1_d2 = nv.nn_indices_mm(queries, ref_points, 'bf16')[0]
    row('indices-bf16',
        lambda: nv.nn_indices_mm(queries, ref_points, 'bf16'),
        lambda o: o[0], lib_bf16, bf16_call, kernel='E1',
        items=nv.mm_bf16_items(Q, R),
        library_max_d2_gap=None if lib_d2 is None else float(
            torch.max(torch.abs(lib_d2 - e1_d2))))
    row('vpu', lambda: nv.nn_vpu(queries, ref_points), lambda o: o[0],
        lib_exact, exact_call, kernel='E2',
        items=nv.tiled_items(Q, R, nv._QB, nv._RB))
    for qb, rb in SWEEP:
        name = f'sweep {qb}x{rb}'
        try:
            row(name, lambda a=qb, b=rb: nv.nn_indices_tiled(
                queries, ref_points, a, b), lambda o: o[0], lib_exact,
                exact_call, kernel='E3', qb=qb, rb=rb,
                items=nv.tiled_items(Q, R, qb, rb))
        except nv.TileTooLarge as exc:
            rows.append(dict(name=name, ms=None, library_ms=lib_exact,
                             library=exact_call, kernel='E3', qb=qb, rb=rb,
                             failed=str(exc)))
            log(f'{name:14s} failed: {exc}')
    log(f'queries {Q}, reference {R}; E6 scanned {share:.4f} of its '
        'reference tiles')
    return rows


def device_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print('no CUDA device: the shootout measures the card',
              file=sys.stderr)
        return 1
    smi = device_line()
    print(f'device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}')
    q, r, pay = (torch.tensor(a, device='cuda') for a in make_scene())
    rows = run(q, r, pay)
    print(json.dumps(dict(device=smi, queries=N_QUERIES, refs=N_REFS,
                          rows=rows)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
