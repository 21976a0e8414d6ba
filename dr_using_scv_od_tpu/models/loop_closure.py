"""Loop-closure detection and verification.

NEW capability completing the pose-graph backend (the reference has no
loop closures - GT poses need none). Fixed-shape design:

  1. candidate proposal: pairwise distances between estimated keyframe
    positions; pairs closer than `radius` but more than `min_gap` frames
    apart, top-K by distance (one sort of the F x F distance matrix);
  2. verification: GICP registration per candidate (lax.map over the
    static K), accepted when enough correspondences converge with low
    error;
  3. accepted pairs become weighted pose-graph edges
    (posegraph.make_odometry_graph loop args).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..ops import geometry
from . import gicp


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    radius: float = 10.0        # candidate search radius (m)
    min_gap: int = 10           # minimum frame separation
    max_candidates: int = 8     # static K
    # verification: fraction of the source scan's valid points that must
    # find correspondences (scales from dense KITTI scans down to tiny
    # test scenes, unlike an absolute count)
    min_corr_frac: float = 0.25
    # Euclidean RMS bound: aligned scans against 1 m voxel Gaussians
    # still show ~0.45 m of discretization residual; misaligned pairs
    # jump past 0.8 m or lose correspondences entirely
    max_rmse: float = 0.6
    edge_weight: float = 3.0


class LoopResult(NamedTuple):
    edge_i: jnp.ndarray     # [K] int32 (-1 = unused row)
    edge_j: jnp.ndarray     # [K]
    edge_T: jnp.ndarray     # [K, 4, 4] measured i_T_j
    edge_w: jnp.ndarray     # [K] weight, 0 for rejected/unused
    n_accepted: jnp.ndarray


def detect(xyz: jnp.ndarray, valid: jnp.ndarray, poses: jnp.ndarray,
           cfg: PipelineConfig, lc: LoopConfig | None = None) -> LoopResult:
    """xyz [F,N,3], valid [F,N], poses [F,4,4] (estimated)."""
    lc = lc or LoopConfig()
    F = poses.shape[0]
    K = lc.max_candidates

    t = poses[:, :3, 3]
    d = jnp.linalg.norm(t[:, None, :] - t[None, :, :], axis=-1)
    gap = jnp.abs(jnp.arange(F)[:, None] - jnp.arange(F)[None, :])
    cand = (d < lc.radius) & (gap > lc.min_gap) \
        & (jnp.arange(F)[:, None] < jnp.arange(F)[None, :])
    score = jnp.where(cand, d, jnp.inf).reshape(-1)
    order = jnp.argsort(score)[:K]
    ei = (order // F).astype(jnp.int32)
    ej = (order % F).astype(jnp.int32)
    ok = jnp.isfinite(score[order])
    ei = jnp.where(ok, ei, -1)
    ej = jnp.where(ok, ej, -1)

    def verify(args):
        i, j, use = args
        i_s = jnp.maximum(i, 0)
        j_s = jnp.maximum(j, 0)
        # register scan j against scan i, warm-started with the current
        # pose estimates
        T_init = geometry.matmul(geometry.inverse_se3(poses[i_s]),
                                 poses[j_s])
        res = gicp.scan_to_scan(xyz[j_s], valid[j_s] & use,
                                xyz[i_s], valid[i_s] & use,
                                cfg.gicp, T_init=T_init)
        min_corr = lc.min_corr_frac * jnp.sum(valid[j_s])
        good = use & (res.n_corr >= min_corr) \
            & (res.rmse < lc.max_rmse)
        return res.T, jnp.where(good, lc.edge_weight, 0.0)

    T_edges, weights = jax.lax.map(
        verify, (ei, ej, ei >= 0))
    return LoopResult(edge_i=ei, edge_j=ej, edge_T=T_edges,
                      edge_w=weights,
                      n_accepted=jnp.sum(weights > 0).astype(jnp.int32))
