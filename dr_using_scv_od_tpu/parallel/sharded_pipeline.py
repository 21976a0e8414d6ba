"""Multi-chip window pipeline: frame-block data parallelism with a ring
halo exchange for the tracking boundary.

Distribution design (SURVEY.md sections 2.4, 5 - all new, the reference is
single-process):

  * Segmentation stages are per-frame independent -> each device processes a
    contiguous block of frames (dp axis).
  * Tracking couples only consecutive frames (src/ssc.cpp:1450-1452), so a
    device needs exactly ONE remote frame: the first frame of its right
    neighbour's block. That halo moves with a single `ppermute`.
  * DELIBERATE DIVERGENCE: the reference's tracking mutates frame t+1
    before pair (t+1, t+2) runs, a strictly sequential chain. Sharding
    breaks the chain at block boundaries: the boundary pair is judged
    against the neighbour's *unmutated* first frame and the mutation to it
    is dropped. Verdicts (dynamic/static states) remain per-block exact;
    only split/merge bookkeeping across the boundary differs.

The global last frame receives no verdicts (same as the reference); on the
last shard the wrapped-around halo's verdicts for its final frame are
masked out.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import PipelineConfig
from ..models import pipeline as pipeline_mod
from ..models import tracking as tracking_mod
from ..types import STATE_UNKNOWN


def _block_fn(xyz, intensity, valid, poses, cfg: PipelineConfig,
              axis: str):
    """Per-device body: segment the local frame block, exchange the halo,
    track local pairs + the boundary pair."""
    n_shards = jax.lax.psum(1, axis)
    my_id = jax.lax.axis_index(axis)

    frames = pipeline_mod.process_window(xyz, intensity, valid, poses, cfg)

    in_grid = frames.state.point_voxel >= 0
    pt_valid = in_grid & valid

    # ---- halo: send my first frame's (table, grid, pose) to the LEFT
    # neighbour, so each shard holds its right neighbour's first frame.
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]

    def send_first(a):
        return jax.lax.ppermute(a[:1], axis, perm)

    halo_table = jax.tree.map(send_first, frames.state.clusters)
    halo_grid = send_first(frames.state.label_grid)
    halo_pose = send_first(poses)

    # ---- extended window: local frames + halo as the (f+1)-th frame.
    ext_tables = jax.tree.map(
        lambda loc, h: jnp.concatenate([loc, h], axis=0),
        frames.state.clusters, halo_table)
    ext_grids = jnp.concatenate([frames.state.label_grid, halo_grid], 0)
    ext_poses = jnp.concatenate([poses, halo_pose], 0)
    # halo frame never acts as a tracking 'prev': pad its point arrays
    zero_pts = jnp.zeros_like(xyz[:1])
    ext_xyz = jnp.concatenate([xyz, zero_pts], 0)
    ext_pv = jnp.concatenate(
        [frames.state.point_voxel,
         jnp.full_like(frames.state.point_voxel[:1], -1)], 0)
    ext_valid = jnp.concatenate(
        [pt_valid, jnp.zeros_like(pt_valid[:1])], 0)

    tr = tracking_mod.track_window(ext_xyz, ext_pv, ext_valid, ext_grids,
                                   ext_tables, ext_poses, cfg)

    f = xyz.shape[0]
    tables = jax.tree.map(lambda a: a[:f], tr.tables)
    grids = tr.label_grids[:f]

    # mask the wrapped-around verdicts of the global final frame
    is_last_shard = my_id == n_shards - 1
    last_state = tables.state[-1]
    masked = jnp.where(is_last_shard,
                       jnp.full_like(last_state, STATE_UNKNOWN), last_state)
    state = tables.state.at[-1].set(masked)
    tables = tables.replace(state=state)
    n_dyn = tr.n_dynamic[:f]
    n_dyn = n_dyn.at[-1].set(jnp.where(is_last_shard, 0, n_dyn[-1]))

    # final per-point verdicts
    G = cfg.grid.bin_num
    C = cfg.shapes.max_clusters
    pv_safe = jnp.clip(frames.state.point_voxel, 0, G - 1)
    pc = jnp.take_along_axis(grids, pv_safe, axis=1)
    pc = jnp.where(pt_valid, pc, -1)
    st = jnp.take_along_axis(tables.state, jnp.clip(pc, 0, C - 1), axis=1)
    removed = (pc >= 0) & (st == 1)
    if cfg.track.dynamic_bbox_sweep:
        removed = removed | pipeline_mod._dynamic_bbox_sweep(
            xyz, tables, cfg)
    removed = removed & valid
    return removed, tables.state, n_dyn


def sharded_run_window(xyz: jnp.ndarray, intensity: jnp.ndarray,
                       valid: jnp.ndarray, poses: jnp.ndarray,
                       cfg: PipelineConfig, mesh: Mesh,
                       axis: str = "dp"
                       ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Distributed run_window: frames sharded over `axis` of `mesh`.

    Returns (removed [F,N] bool, states [F,C] int32, n_dynamic [F] int32),
    all sharded along the frame axis.
    """
    fn = jax.shard_map(
        functools.partial(_block_fn, cfg=cfg, axis=axis),
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)(xyz, intensity, valid, poses)
