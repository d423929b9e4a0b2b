"""laser_slam_tpu_torch — the PyTorch/CUDA port of laser_slam_tpu.

Same layout and function names as the JAX package, so each function has
an obvious counterpart:

  ops/       SE(3), point clouds, nearest neighbours, normals, ICP,
             scan-context descriptors
  graph/     factor-graph arrays, the Gauss-Newton/PCG solver, its
             Woodbury cache and marginal covariances
  pipeline/  the online SLAM step, its host runner (multi-robot tracks
             included), device maps, place recognition, replay streams,
             the host API's LaserSlamWorker
  core/      the host API (LaserTrack, IncrementalEstimator, the
             trajectory and its types), checkpoints, CSV and trajectory
             exports, the benchmarker (host timers)
  csrc/      hand-written CUDA kernels (built with nvcc at first use)

Imports torch and numpy only; never jax.
"""

import torch as _torch

# Geometry and solver math relies on small (3x3 / 6x6) contractions that
# lose their accuracy under TF32 (about three decimal digits).  The JAX
# package forces 'highest' matmul precision for the same reason.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from laser_slam_tpu_torch.config import (  # noqa: E402
    Config,
    EstimatorConfig,
    IcpConfig,
    InputFilterConfig,
    LaserTrackConfig,
    SolverConfig,
    slice1_config,
)

__version__ = '0.1.0'
