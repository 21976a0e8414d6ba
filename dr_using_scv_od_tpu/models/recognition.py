"""Rule-based object recognition: building / tree / car.

Re-design of `SSC::recognize` (src/ssc.cpp:834-895) + the feature builder
(src/ssc.cpp:658-758). The reference's live features are bbox-derived
([6]=max z, [7]=footprint area dx*dy, [8]=polar-angle spread, [9]=min z;
the six "eigen" slots are hard-coded 1.0); the decision tree is:

    area > car_square          -> regionGrowing ? building : tree
    else if min_z < cfg.min_z
         and area < car_square
         and max_z < cfg.max_z -> car
    else                       -> tree

The PCL region-growing plane check ("RPC", src/ssc.cpp:797-832) is replaced
by a per-voxel planarity test (batched 3x3 eigendecomp of per-voxel point
covariances): a cluster is 'planar enough' when >= plane_ratio of its points
lie in voxels whose smallest-eigenvalue fraction is below
plane_flatness_thr - the reference's criterion was >= 20% of points in
planar region-growing segments (src/ssc.cpp:825-831).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..types import TYPE_BUILDING, TYPE_CAR, TYPE_TREE, ClusterTable
from ..ops import geometry, segment_ops


class Features(NamedTuple):
    """The live slots of the reference's 11-dim feature matrix
    (src/ssc.cpp:723-751)."""
    max_z: jnp.ndarray       # [C]  slot 6
    area: jnp.ndarray        # [C]  slot 7 (dx * dy)
    angle_spread: jnp.ndarray  # [C]  slot 8 (polar spread of bbox corners)
    min_z: jnp.ndarray       # [C]  slot 9
    planar_ratio: jnp.ndarray  # [C]  RPC replacement


def _planarity_from_sums(n, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz,
                         cfg: PipelineConfig) -> jnp.ndarray:
    """Planarity decision from raw per-voxel moment SUMS ([G] planes)."""
    safe_n = jnp.maximum(n, 1.0)
    mx, my, mz = sx / safe_n, sy / safe_n, sz / safe_n
    cxx = sxx / safe_n - mx * mx
    cyy = syy / safe_n - my * my
    czz = szz / safe_n - mz * mz
    cxy = sxy / safe_n - mx * my
    cxz = sxz / safe_n - mx * mz
    cyz = syz / safe_n - my * mz
    # planarity test WITHOUT an eigensolve: e_lo/tr <= thr is exactly
    # "C - thr*tr*I is NOT positive definite", and Sylvester's criterion
    # decides 3x3 positive definiteness from the three leading principal
    # minors - ~25 mul/adds per voxel in pure scalar planes versus the
    # trigonometric closed form's arccos/cos/sqrt chain, which dominated
    # this [G]=1.3M-wide stage. Scalar planes only, no [G,3,3] stack
    # (models/gicp.py has the same discipline).
    tr = jnp.maximum(cxx + cyy + czz, 1e-12)
    t = cfg.recog.plane_flatness_thr * tr
    a00, a11, a22 = cxx - t, cyy - t, czz - t
    d1 = a00
    d2 = a00 * a11 - cxy * cxy
    d3 = (a00 * (a11 * a22 - cyz * cyz)
          - cxy * (cxy * a22 - cyz * cxz)
          + cxz * (cxy * cyz - a11 * cxz))
    pos_def = (d1 > 0.0) & (d2 > 0.0) & (d3 > 0.0)   # e_lo > thr * tr
    return (n >= cfg.recog.plane_min_pts) & ~pos_def


def voxel_planarity_from_moments(count: jnp.ndarray, moments: jnp.ndarray,
                                 cfg: PipelineConfig) -> jnp.ndarray:
    """[G] bool planarity from the segmentation stage's fused moment
    scatter (ops/quantize.voxel_stats_moments): no extra scatter pass.
    `moments` columns: (sx, sy, sz, sxx, syy, szz, sxy, sxz, syz)."""
    n = count.astype(jnp.float32)
    return _planarity_from_sums(
        n, moments[:, 0], moments[:, 1], moments[:, 2], moments[:, 3],
        moments[:, 4], moments[:, 5], moments[:, 6], moments[:, 7],
        moments[:, 8], cfg)


def voxel_planarity(xyz: jnp.ndarray, point_voxel: jnp.ndarray,
                    in_fov: jnp.ndarray, cfg: PipelineConfig) -> jnp.ndarray:
    """[G] bool: voxels whose points form a locally planar patch.

    Standalone (point-level) path for callers without the segmentation
    stage's fused moment scatter; the hot pipeline uses
    voxel_planarity_from_moments instead (identical decision: any voxel
    whose points reach a live cluster's histogram contains exactly the
    in-FOV points of that cluster, so the in_fov mask and the
    point-in-live-cluster mask agree on every voxel that is consumed).
    """
    g = cfg.grid.bin_num
    seg = jnp.where(in_fov, point_voxel, g)

    def ssum(x):
        return jax.ops.segment_sum(jnp.where(in_fov, x, 0.0), seg,
                                   num_segments=g + 1)[:g]

    # scalar segment-sums only: a single [N,3,3] scatter made XLA
    # materialize multi-GB scatter intermediates
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    n = ssum(jnp.ones_like(x))
    return _planarity_from_sums(
        n, ssum(x), ssum(y), ssum(z), ssum(x * x), ssum(y * y),
        ssum(z * z), ssum(x * y), ssum(x * z), ssum(y * z), cfg)


def recognize(table: ClusterTable, xyz: jnp.ndarray,
              point_cluster: jnp.ndarray, point_voxel: jnp.ndarray,
              cfg: PipelineConfig,
              label_grid: jnp.ndarray | None = None,
              voxel_count: jnp.ndarray | None = None,
              planar_vox: jnp.ndarray | None = None,
              n_planar: jnp.ndarray | None = None
              ) -> tuple[ClusterTable, Features]:
    """Classify every live cluster; returns updated table + features.

    With `label_grid` + `voxel_count` (the segmentation stage has both),
    per-cluster planar-point counts come from ONE weighted outer-product
    histogram over the grid (points-per-voxel x planar mask, keyed by the
    voxel's cluster) instead of an [N]-from-[G] gather plus a scatter -
    identical result, and cheaper on the previous accelerator (not yet
    measured on the H100). Without them the point-level
    fallback runs (same semantics; used by callers without grid state).

    `planar_vox`: precomputed per-voxel planarity (the segmentation
    stage's fused moment scatter provides it via SegmentResult); when
    absent the point-level scatter fallback runs here.
    """
    C = table.c
    valid_pt = point_cluster >= 0

    if n_planar is None:
        if planar_vox is None:
            planar_vox = voxel_planarity(xyz, point_voxel, valid_pt, cfg)
        if label_grid is not None and voxel_count is not None:
            w = jnp.where(planar_vox, voxel_count.astype(jnp.float32),
                          0.0)
            n_planar = segment_ops.grid_label_counts(
                label_grid, C, weights=w,
                weight_bound=cfg.shapes.max_points + 1)
        else:
            pv_safe = jnp.clip(point_voxel, 0, cfg.grid.bin_num - 1)
            pt_planar = valid_pt & planar_vox[pv_safe]
            n_planar = segment_ops.segment_count(point_cluster,
                                                 pt_planar, C)
    n_pts = jnp.maximum(table.n_points, 1)
    planar_ratio = n_planar.astype(jnp.float32) / n_pts.astype(jnp.float32)

    dx = table.bbox_max[:, 0] - table.bbox_min[:, 0]
    dy = table.bbox_max[:, 1] - table.bbox_min[:, 1]
    area = dx * dy
    max_z = table.bbox_max[:, 2]
    min_z = table.bbox_min[:, 2]
    angle_spread = jnp.abs(geometry.polar_angle_deg(table.bbox_max)
                           - geometry.polar_angle_deg(table.bbox_min))

    is_big = area > cfg.recog.car_square
    is_planar = planar_ratio >= cfg.recog.plane_ratio
    is_car = ((min_z < cfg.recog.min_z)
              & (area < cfg.recog.car_square)
              & (max_z < cfg.recog.max_z))

    typ = jnp.where(
        is_big,
        jnp.where(is_planar, TYPE_BUILDING, TYPE_TREE),
        jnp.where(is_car, TYPE_CAR, TYPE_TREE),
    ).astype(jnp.int32)
    typ = jnp.where(table.valid, typ, -1)

    feats = Features(max_z=max_z, area=area, angle_spread=angle_spread,
                     min_z=min_z, planar_ratio=planar_ratio)
    return table.replace(type=typ), feats
