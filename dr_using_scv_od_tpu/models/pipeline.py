"""Frame and window pipeline drivers.

Analog of `SSC::segDF` (src/ssc.cpp:1428-1548): per-frame
process -> segment -> recognize, then pairwise tracking over the window.
Here the per-frame stage is one jittable function (`process_frame`) mapped
over the frame axis (lax.map/shard_map; the reference loops serially,
src/ssc.cpp:1435-1445), and tracking is a `lax.scan` over consecutive pairs
(models/tracking.py) because its cluster mutations are a Markov recurrence.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..types import FrameState, PointCloud, VoxelGrid
from . import patchwork, recognition, segmentation


class FrameOutput(NamedTuple):
    state: FrameState
    features: recognition.Features
    n_clusters: jnp.ndarray
    overflow_points: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("cfg",))
def process_frame(xyz: jnp.ndarray, intensity: jnp.ndarray,
                  valid: jnp.ndarray, pose: jnp.ndarray,
                  cfg: PipelineConfig) -> FrameOutput:
    """Full single-frame pipeline: ground removal -> curved-voxel build ->
    clustering -> refinement -> recognition.

    Mirrors the per-frame body of segDF (src/ssc.cpp:1435-1445) minus
    tracking.
    """
    pw = patchwork.estimate_ground(xyz, valid, cfg.patchwork)

    seg, point_voxel, grid = segmentation.segment_frame(
        xyz, intensity, pw.nonground, pw.ground, pw.dropped, cfg)

    table, feats = recognition.recognize(
        seg.clusters, xyz, seg.point_cluster, point_voxel, cfg,
        label_grid=seg.label_grid, voxel_count=grid.count,
        planar_vox=seg.planar_vox, n_planar=seg.n_planar)

    state = FrameState(
        points=PointCloud(xyz=xyz, intensity=intensity, valid=valid),
        grid=grid,
        label_grid=seg.label_grid,
        clusters=table,
        point_voxel=point_voxel,
        point_cluster=seg.point_cluster,
        pose=pose,
        point_route=seg.point_route,
    )
    return FrameOutput(state=state, features=feats,
                       n_clusters=seg.n_clusters,
                       overflow_points=seg.overflow_points)


def process_window(xyz: jnp.ndarray, intensity: jnp.ndarray,
                   valid: jnp.ndarray, poses: jnp.ndarray,
                   cfg: PipelineConfig) -> FrameOutput:
    """Map the frame pipeline over a [F, ...] window, one frame after
    another (sharded variant in parallel/sharded_pipeline.py).

    `lax.map` rather than `vmap`: on an H100 80GB HBM3 (700 W limit) the
    6-frame full-width `run_window` took 72.2 ms with `lax.map` against
    75.0 ms with `vmap`, with 0.68 GB of XLA temporaries against 3.87 GB.
    One frame already fills the card, so batching frames buys nothing."""
    fn = functools.partial(process_frame, cfg=cfg)
    return jax.lax.map(lambda a: fn(*a), (xyz, intensity, valid, poses))


def _dynamic_bbox_sweep(xyz: jnp.ndarray, tables, cfg: PipelineConfig
                        ) -> jnp.ndarray:
    """[F,N] bool: point lies inside the inflated bbox of a same-frame
    cluster judged DYNAMIC. Extension beyond the reference (see
    TrackingConfig.dynamic_bbox_sweep): reclaims the dynamic returns that
    never reach the verdict lattice (ground-routed car bottoms,
    out-of-grid-range points, bbox-dropped fragments).

    Chunked over cluster rows so the [F, N, chunk] broadcast stays small.
    """
    from ..types import STATE_DYNAMIC
    F, N, _ = xyz.shape
    C = tables.valid.shape[1]
    m = cfg.track.sweep_margin
    dyn = tables.valid & (tables.state == STATE_DYNAMIC)       # [F,C]
    big = jnp.float32(jnp.finfo(jnp.float32).max / 4)
    lo = jnp.where(dyn[..., None], tables.bbox_min - m, big)   # [F,C,3]
    hi = jnp.where(dyn[..., None], tables.bbox_max + m, -big)

    chunk = min(64, C)
    n_chunks = (C + chunk - 1) // chunk

    def body(k, acc):
        l = jax.lax.dynamic_slice_in_dim(lo, k * chunk, chunk, axis=1)
        h = jax.lax.dynamic_slice_in_dim(hi, k * chunk, chunk, axis=1)
        inside = jnp.all((xyz[:, :, None, :] >= l[:, None, :, :])
                         & (xyz[:, :, None, :] <= h[:, None, :, :]), -1)
        return acc | jnp.any(inside, axis=2)

    return jax.lax.fori_loop(0, n_chunks, body,
                             jnp.zeros((F, N), bool))


class WindowResult(NamedTuple):
    frames: FrameOutput            # stacked per-frame outputs (pre-tracking)
    tables: jnp.ndarray            # finalized ClusterTable [F, C]
    label_grids: jnp.ndarray       # mutated label grids [F, G]
    point_cluster: jnp.ndarray     # [F, N] final cluster per point
    removed: jnp.ndarray           # [F, N] bool - judged dynamic, removed
    n_dynamic: jnp.ndarray         # [F] per-pair dynamic verdicts
    new_row_overflow: jnp.ndarray      # ran out of cluster rows
    track_point_overflow: jnp.ndarray  # points past max_track_points
    track_counter: jnp.ndarray     # next unassigned track id (streaming)


@functools.partial(jax.jit, static_argnames=("cfg", "bbox_dropped_dynamic"))
def run_window(xyz: jnp.ndarray, intensity: jnp.ndarray,
               valid: jnp.ndarray, poses: jnp.ndarray,
               cfg: PipelineConfig,
               bbox_dropped_dynamic: bool = False,
               init_track=None) -> WindowResult:
    """The whole batch pipeline over one window: per-frame segmentation
    (data-parallel) + pairwise tracking (sequential scan) + final per-point
    dynamic verdicts. Analog of segDF (src/ssc.cpp:1428-1452) + the
    map-assembly step (saveSegCloud mode 3, src/ssc.cpp:531-567).

    `init_track`: optional streaming carry (table, label_grid, counter)
    for the first frame, produced by the previous overlapping window
    (models/engine.py); tracking.track_window documents the semantics."""
    from . import tracking
    from .segmentation import ROUTE_BBOX_DYNAMIC

    frames = process_window(xyz, intensity, valid, poses, cfg)

    in_grid = frames.state.point_voxel >= 0
    tr = tracking.track_window(
        xyz, frames.state.point_voxel, in_grid & valid,
        frames.state.label_grid, frames.state.clusters, poses, cfg,
        init_carry=init_track)

    # final per-point cluster: the tracking scan already paid the
    # [N]-from-[G] lookup per frame (TrackingResult.point_cluster)
    from ..ops import segment_ops
    C = cfg.shapes.max_clusters
    pc = tr.point_cluster

    # per-point dynamic flag via the select tree instead of an [F,N]
    # gather from the [F,C] state table
    dyn_row = tr.tables.state == 1                     # [F, C] bool
    pc_safe = jnp.clip(pc, 0, C - 1)
    is_dyn = jax.vmap(segment_ops.small_table_lookup,
                      in_axes=(0, 0, None))(dyn_row, pc_safe, 1)
    removed = (pc >= 0) & is_dyn
    if bbox_dropped_dynamic:
        removed = removed | (frames.state.point_route == ROUTE_BBOX_DYNAMIC)
    if cfg.track.dynamic_bbox_sweep:
        removed = removed | _dynamic_bbox_sweep(xyz, tr.tables, cfg)
    removed = removed & valid

    return WindowResult(frames=frames, tables=tr.tables,
                        label_grids=tr.label_grids, point_cluster=pc,
                        removed=removed, n_dynamic=tr.n_dynamic,
                        new_row_overflow=tr.new_row_overflow,
                        track_point_overflow=tr.track_point_overflow,
                        track_counter=tr.counter)
