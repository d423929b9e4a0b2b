"""What bounds E1 bf16 on the card, and E1 beside an earlier checkout's.

Builds text variants of ``csrc/nn_variants.cu`` with nvcc: the kernels
as they are (``as_is``), the items kernel without its min pass (its
mma alone: ``no_min``), without its mma (the min pass over an FMUL a
score: ``no_mma``), and with ``mma.sync`` m16n8k16 in place of m16n8k8
(``k16``); times each variant's kernels by ``torch.profiler`` at the
shootout's 8192 x 65536 (seed 3), in the order given and then in
reverse. With ``--parent DIR`` it then times E1's call and the kernel
alone on its set-up for the package in DIR (an earlier checkout) and
for this one, a subprocess each, in the order parent, this, this,
parent. A measurement aid for ``PERF.md``: no path of the port calls
it.

    python -m laser_slam_tpu_torch.experiments.e1_probe [--parent DIR]

It prints one JSON line a measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

from laser_slam_tpu_torch.experiments import nn_shootout as sh
from laser_slam_tpu_torch.ops import cuda_build

_MIN = 'for (int e = 0; e < 4; ++e) mn[f][e] = fminf(mn[f][e], d[e]);'
_SCAN = '#pragma unroll\n        ' + _MIN     # the full steps' min pass
_MMA = '        mma_bf16_1688(d, a[f][0], a[f][1], b);\n' + _SCAN
_FMUL = ''.join(
    f'        d[{e}] = __fmul_rn(__uint_as_float(a[f][{e % 2}]), '
    f'__uint_as_float(b + {e // 2}u));\n' for e in range(4))
_K8 = ('"mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "\n'
       '      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\\n"')
_K16 = ('"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
        '      "{%0, %1, %2, %3}, {%4, %5, %11, %11}, {%6, %11}, '
        '{%7, %8, %9, %10};\\n"')
_K8_ARGS = '"f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));'
_K16_ARGS = '"f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f), "r"(0u));'

# E1's call and its kernel alone, run in the checkout given as argv[1].
_TIMER = '''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from laser_slam_tpu_torch.experiments import nn_shootout as sh
from laser_slam_tpu_torch.ops import nn_variants as nv
from laser_slam_tpu_torch.pipeline.profiling import event_ms
q, r, _ = (torch.tensor(a, device='cuda')
           for a in sh.make_scene(8192, 65536, 3))
if hasattr(nv, 'mm_bf16_setup'):
    tab = nv.mm_bf16_setup(q, r)
    alone = lambda: nv._launch_mm_indices_bf16(q, tab)
else:
    r_ext = nv.extend_reference(r)
    alone = lambda: nv._launch_mm_bf16(q, r_ext)
call = lambda: nv.nn_indices_mm(q, r, 'bf16')
print(json.dumps(dict(tree=sys.argv[1], call_ms=event_ms(call, 50),
                      alone_ms=event_ms(alone, 50))))
'''


def variants(source: str) -> dict:
    """The source texts probed, by name."""
    for piece in (_MIN, _MMA, _K8, _K8_ARGS):
        if source.count(piece) != 1:
            raise RuntimeError(f'csrc/nn_variants.cu changed: {piece!r}')
    return dict(
        as_is=source,
        no_min=source.replace(_MIN, _MIN.replace('fminf(mn[f][e], d[e])',
                                                 'd[e]')),
        no_mma=source.replace(_MMA, _FMUL + _SCAN),
        k16=source.replace(_K8, _K16).replace(_K8_ARGS, _K16_ARGS))


def build(texts: dict, workdir: str) -> dict:
    """Compile each text, all nvcc processes at once; the loaded
    libraries by name."""
    jobs = {}
    for name, text in texts.items():
        d = os.path.join(workdir, name)
        os.makedirs(d)
        for h in os.listdir(cuda_build.CSRC_DIR):
            if h.endswith('.cuh'):
                shutil.copy(os.path.join(cuda_build.CSRC_DIR, h), d)
        with open(os.path.join(d, 'nn_variants.cu'), 'w') as f:
            f.write(text)
        jobs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-o',
             os.path.join(d, 'lib.so'), os.path.join(d, 'nn_variants.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed on {name}:\n{out}')
        lib = ctypes.CDLL(os.path.join(workdir, name, 'lib.so'))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lsl_e1_setup.argtypes = [p, i, i, i, p, p, i, p]
        lib.lsl_e1_indices.argtypes = [p, p, i, i, p, p, p, i, p]
        libs[name] = lib
    return libs


def kernel_ms(lib, q, ref, calls: int = 20) -> dict:
    """Device ms a call of each E1 kernel of ``lib`` (set-up once, then
    ``calls`` calls of the two passes, profiled)."""
    Q, R = q.shape[0], ref.shape[0]
    R8 = -(-R // 8) * 8
    dev = q.device
    rows = torch.empty((R8, 2), dtype=torch.int32, device=dev)
    keys = torch.empty(Q, dtype=torch.int64, device=dev)
    d2 = torch.empty(Q, device=dev)
    idx = torch.empty(Q, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        if lib.lsl_e1_indices(q.data_ptr(), rows.data_ptr(), Q, R,
                              keys.data_ptr(), d2.data_ptr(), idx.data_ptr(),
                              dev.index, stream):
            raise RuntimeError('lsl_e1_indices refused the launch')

    if lib.lsl_e1_setup(ref.data_ptr(), Q, R, R8, rows.data_ptr(),
                        keys.data_ptr(), dev.index, stream):
        raise RuntimeError('lsl_e1_setup refused the launch')
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    return {e.key.split('(')[0]: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages() if e.key.startswith('e1_')}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', help='an earlier checkout to time beside')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('no CUDA device: the probe measures the card', file=sys.stderr)
        return 1
    print(json.dumps(dict(device=sh.device_line())), flush=True)
    with open(os.path.join(cuda_build.CSRC_DIR, 'nn_variants.cu')) as f:
        texts = variants(f.read())
    q, ref, _ = (torch.tensor(a, device='cuda')
                 for a in sh.make_scene(8192, 65536, seed=3))
    with tempfile.TemporaryDirectory() as workdir:
        libs = build(texts, workdir)
        for name in list(libs) + list(libs)[::-1]:
            print(json.dumps(dict(variant=name,
                                  **kernel_ms(libs[name], q, ref))),
                  flush=True)
    if args.parent:
        here = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        for root in (args.parent, here, here, args.parent):
            subprocess.run([sys.executable, '-c', _TIMER,
                            os.path.abspath(root)], check=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
