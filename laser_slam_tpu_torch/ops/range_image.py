"""Normal estimation dispatch (the range-image methods come in slice 2).

Counterpart of ``laser_slam_tpu/ops/range_image.py``; only
:func:`compute_normals` is ported, with its ``'knn'`` branch.
"""

from __future__ import annotations

import torch

from laser_slam_tpu_torch.ops.cloud import Cloud, estimate_normals


def compute_normals(cloud: Cloud, icp_config) -> torch.Tensor:
    """Per-scan normals dispatched on ``IcpConfig.normal_method``.

    ``'knn'`` is kNN PCA (:func:`cloud.estimate_normals`).  ``'auto'``,
    ``'image_pca'`` and ``'range_image'`` use the range image, which the
    port takes on in slice 2 (ROADMAP queue 1); they raise here.
    """
    method = icp_config.normal_method
    if method in ('auto', 'image_pca', 'range_image'):
        raise NotImplementedError(
            f'normal_method={method!r} needs the range image, which the '
            "port adds in slice 2; use normal_method='knn'")
    if method != 'knn':
        raise ValueError(f'unknown normal_method {method!r}')
    return estimate_normals(cloud, knn=icp_config.normal_knn)
