"""Window odometry: GICP scan-to-scan chains and scan-to-map refinement.

NEW capability: replaces the reference's ground-truth pose input
(src/ssc.cpp:913-995) with estimated motion, so the dynamic-removal
pipeline (models/pipeline.py) runs with no pose supervision.

Design:
  * consecutive scan pairs register with voxelized GICP (models/gicp.py),
    sequentially via `lax.scan` (constant-velocity warm starts);
  * relative transforms compose into world poses (posegraph.odometry_chain);
  * optional pose-graph refinement hooks in loop closures later
    (models/posegraph.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from . import gicp, posegraph


class OdometryResult(NamedTuple):
    poses: jnp.ndarray       # [F, 4, 4] world_T_frame (frame 0 = identity)
    rel_T: jnp.ndarray       # [F-1, 4, 4] frame_t_T_frame_{t+1}
    n_corr: jnp.ndarray      # [F-1]
    final_error: jnp.ndarray  # [F-1]


def estimate_window_poses(xyz: jnp.ndarray, valid: jnp.ndarray,
                          cfg: PipelineConfig) -> OdometryResult:
    """Sequential scan-to-scan odometry over a [F, N, 3] window.

    Registration maps frame t+1 into frame t, warm-started with the
    previous relative transform (constant-velocity model).
    """
    F = xyz.shape[0]

    def step(carry, t):
        T_prev_rel = carry
        tgt_xyz = xyz[t]
        tgt_valid = valid[t]
        src_xyz = xyz[t + 1]
        src_valid = valid[t + 1]
        vm = gicp.build_voxel_map(tgt_xyz, tgt_valid, cfg.gicp)
        res = gicp.register_pyramid(src_xyz, src_valid, vm, cfg.gicp,
                                    T_init=T_prev_rel)
        return res.T, (res.T, res.n_corr, res.final_error)

    T0 = jnp.eye(4, dtype=xyz.dtype)
    _, (rel_T, n_corr, err) = jax.lax.scan(step, T0,
                                           jnp.arange(F - 1))
    poses = posegraph.odometry_chain(rel_T)
    return OdometryResult(poses=poses, rel_T=rel_T, n_corr=n_corr,
                          final_error=err)


def estimate_window_poses_scan_to_map(xyz: jnp.ndarray, valid: jnp.ndarray,
                                      cfg: PipelineConfig
                                      ) -> OdometryResult:
    """Scan-to-MAP odometry: each frame registers against the accumulated
    voxel map of all previous frames (running Gaussian sums merged per
    frame - VoxelMap is additive), which suppresses the drift of pairwise
    chaining. Sequential by nature (`lax.scan`)."""
    from ..ops import geometry
    F = xyz.shape[0]

    vm0 = gicp.build_voxel_map(xyz[0], valid[0], cfg.gicp)
    T0 = jnp.eye(4, dtype=xyz.dtype)

    def step(carry, t):
        vm, T_world, T_rel_prev = carry
        # warm start: constant velocity in the world frame
        T_init = geometry.matmul(T_world, T_rel_prev)
        src = xyz[t + 1]
        res = gicp.register_pyramid(src, valid[t + 1], vm, cfg.gicp,
                                    T_init=T_init)
        T_new = res.T            # world_T_frame (map frame == frame 0)
        T_rel = geometry.matmul(geometry.inverse_se3(T_world), T_new)
        warped = geometry.transform_points(T_new, src)
        vm = vm.merge(gicp.build_voxel_map(warped, valid[t + 1], cfg.gicp))
        return (vm, T_new, T_rel), (T_new, T_rel, res.n_corr,
                                    res.final_error)

    (_, _, _), (poses_rest, rel_T, n_corr, err) = jax.lax.scan(
        step, (vm0, T0, T0), jnp.arange(F - 1))
    poses = jnp.concatenate([T0[None], poses_rest], axis=0)
    return OdometryResult(poses=poses, rel_T=rel_T, n_corr=n_corr,
                          final_error=err)


def ate_rmse(est_poses: jnp.ndarray, gt_poses: jnp.ndarray) -> jnp.ndarray:
    """Absolute trajectory error (RMSE of translation), gauge-aligned to
    frame 0 (both sequences expressed relative to their first pose)."""
    from ..ops import geometry
    e0 = geometry.inverse_se3(est_poses[0])
    g0 = geometry.inverse_se3(gt_poses[0])
    e = jnp.einsum('ij,fjk->fik', e0, est_poses,
                   precision="highest")[:, :3, 3]
    g = jnp.einsum('ij,fjk->fik', g0, gt_poses,
                   precision="highest")[:, :3, 3]
    return jnp.sqrt(jnp.mean(jnp.sum((e - g) ** 2, axis=-1)))
