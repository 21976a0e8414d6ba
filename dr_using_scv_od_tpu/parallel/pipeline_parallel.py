"""Pipeline parallelism: the per-frame pipeline as a stage pipeline over a
`pp` mesh axis (SURVEY.md section 2.4 - the reference has no parallelism
beyond OpenMP; this is the accelerator-native PP design promised there).

GPipe-style schedule without weights: the stages are *compute* stages of
the per-frame pipeline (ground segmentation -> curved-voxel segmentation ->
recognition), one per device along `pp`. Frames are the microbatches:
frame f enters stage 0 at step f, and its activations ride a `ppermute`
chain down the stage devices, so at steady state all S devices work on S
consecutive frames simultaneously. Total steps T = F + S - 1; the (S-1)
bubble steps at each end are the usual GPipe fill/drain.

Activations move as a fixed-shape `PPBuffer` (the superset of every
inter-stage tensor), which keeps the `lax.switch` over stage bodies
shape-uniform - the same padded-tensor discipline used everywhere else in
this framework. Tracking is NOT part of the PP chain: it is a sequential
cross-frame recurrence (src/ssc.cpp:1450-1452) and runs downstream on the
collected window (models/tracking.py), exactly as in `run_window`.

When to prefer PP over the frame-block DP of sharded_pipeline.py: DP
replicates nothing but needs F >= n_devices frames in flight and per-device
memory for a whole frame block; PP holds ONE frame per device with S-deep
latency, which suits streaming/online operation (scan-by-scan arrival)
where DP has no batch to shard.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import PipelineConfig
from ..models import patchwork, recognition, segmentation
from ..models.recognition import Features
from ..types import ClusterTable


class PPBuffer(NamedTuple):
    """Superset of all inter-stage activations (fixed shapes)."""
    xyz: jnp.ndarray            # [N,3]
    intensity: jnp.ndarray      # [N]
    valid: jnp.ndarray          # [N] bool
    nonground: jnp.ndarray      # [N] bool   (stage: ground)
    ground: jnp.ndarray         # [N] bool
    dropped: jnp.ndarray        # [N] bool
    point_voxel: jnp.ndarray    # [N] i32    (stage: segment)
    point_cluster: jnp.ndarray  # [N] i32
    label_grid: jnp.ndarray     # [G] i32
    # NB: per-voxel intensity stats (VoxelGrid count/mean/var) are consumed
    # INSIDE the segment stage and collected by no downstream stage, so they
    # deliberately do not ride the ppermute handoff (dead link traffic).
    table: ClusterTable         # [C] rows
    feats: Features             # [C] slots  (stage: recognize)
    n_clusters: jnp.ndarray     # scalar i32


def _zeros_buffer(cfg: PipelineConfig) -> PPBuffer:
    N = cfg.shapes.max_points
    G = cfg.grid.bin_num
    C = cfg.shapes.max_clusters
    f32 = functools.partial(jnp.zeros, dtype=jnp.float32)
    i32 = functools.partial(jnp.zeros, dtype=jnp.int32)
    b = functools.partial(jnp.zeros, dtype=bool)
    table = ClusterTable(valid=b((C,)), n_points=i32((C,)),
                         n_voxels=i32((C,)), bbox_min=f32((C, 3)),
                         bbox_max=f32((C, 3)), type=i32((C,)),
                         state=i32((C,)), track_id=i32((C,)))
    feats = Features(max_z=f32((C,)), area=f32((C,)),
                     angle_spread=f32((C,)), min_z=f32((C,)),
                     planar_ratio=f32((C,)))
    return PPBuffer(xyz=f32((N, 3)), intensity=f32((N,)), valid=b((N,)),
                    nonground=b((N,)), ground=b((N,)), dropped=b((N,)),
                    point_voxel=i32((N,)), point_cluster=i32((N,)),
                    label_grid=i32((G,)),
                    table=table, feats=feats, n_clusters=i32(()))


def _stage_ground(buf: PPBuffer, cfg: PipelineConfig) -> PPBuffer:
    pw = patchwork.estimate_ground(buf.xyz, buf.valid, cfg.patchwork)
    return buf._replace(nonground=pw.nonground, ground=pw.ground,
                        dropped=pw.dropped)


def _stage_segment(buf: PPBuffer, cfg: PipelineConfig) -> PPBuffer:
    seg, point_voxel, _grid = segmentation.segment_frame(
        buf.xyz, buf.intensity, buf.nonground, buf.ground, buf.dropped, cfg)
    return buf._replace(point_voxel=point_voxel,
                        point_cluster=seg.point_cluster,
                        label_grid=seg.label_grid,
                        table=seg.clusters, n_clusters=seg.n_clusters)


def _stage_recognize(buf: PPBuffer, cfg: PipelineConfig) -> PPBuffer:
    table, feats = recognition.recognize(buf.table, buf.xyz,
                                         buf.point_cluster,
                                         buf.point_voxel, cfg)
    return buf._replace(table=table, feats=feats)


_LOGICAL_STAGES = (_stage_ground, _stage_segment, _stage_recognize)


def make_stages(cfg: PipelineConfig, n_stages: int
                ) -> List[Callable[[PPBuffer], PPBuffer]]:
    """Partition the 3 logical stages into `n_stages` contiguous groups
    (fused when n_stages < 3; n_stages > 3 leaves pass-through tail stages,
    useful only for schedule testing)."""
    if n_stages < 1:
        raise ValueError("n_stages must be >= 1")
    n_logical = len(_LOGICAL_STAGES)
    groups: List[List] = [[] for _ in range(n_stages)]
    for i, st in enumerate(_LOGICAL_STAGES):
        g = i if n_stages >= n_logical else (i * n_stages) // n_logical
        groups[g].append(st)

    def fuse(fns):
        def run(buf):
            for fn in fns:
                buf = fn(buf, cfg)
            return buf
        return run

    return [fuse(g) for g in groups]


class PPWindowResult(NamedTuple):
    point_voxel: jnp.ndarray    # [F,N]
    point_cluster: jnp.ndarray  # [F,N]
    label_grid: jnp.ndarray     # [F,G]
    table: ClusterTable         # [F,C]
    feats: Features             # [F,C]
    n_clusters: jnp.ndarray     # [F]


def pipelined_process_window(xyz: jnp.ndarray, intensity: jnp.ndarray,
                             valid: jnp.ndarray, cfg: PipelineConfig,
                             mesh: Mesh, axis: str = "pp"
                             ) -> PPWindowResult:
    """Run the per-frame pipeline over [F, ...] inputs with its stages
    spread along `mesh`'s `axis`. Results are bit-identical to
    `pipeline.process_window` (same stage functions, same order); only the
    placement differs. Returns replicated outputs."""
    S = int(mesh.shape[axis])
    stages = make_stages(cfg, S)
    F = int(xyz.shape[0])
    T = F + S - 1

    def body(xyz_all, inten_all, valid_all):
        sid = jax.lax.axis_index(axis)
        buf0 = _zeros_buffer(cfg)
        perm = [(s, s + 1) for s in range(S - 1)]

        def step(carry, t):
            # stage 0 injects frame t (clamped during drain; drained steps
            # recompute a stale frame whose output is never collected)
            f = jnp.clip(t, 0, F - 1)
            inj = buf0._replace(
                xyz=jax.lax.dynamic_index_in_dim(xyz_all, f, keepdims=False),
                intensity=jax.lax.dynamic_index_in_dim(
                    inten_all, f, keepdims=False),
                valid=jax.lax.dynamic_index_in_dim(
                    valid_all, f, keepdims=False))
            buf_in = jax.tree.map(
                lambda a, b: jnp.where(sid == 0, a, b), inj, carry)
            out = jax.lax.switch(sid, stages, buf_in)
            # hand the activations to the next stage device; ppermute
            # zero-fills stage 0's receive side (no wrap-around)
            nxt = (jax.tree.map(
                lambda a: jax.lax.ppermute(a, axis, perm), out)
                if S > 1 else out)
            collected = (out.point_voxel, out.point_cluster, out.label_grid,
                         out.table, out.feats, out.n_clusters)
            return nxt, collected

        _, outs = jax.lax.scan(step, buf0, jnp.arange(T))
        # frame f finishes on the last stage device at step f + S - 1
        final = jax.tree.map(lambda a: a[S - 1:], outs)

        is_last = sid == S - 1

        def replicate(a):
            if a.dtype == jnp.bool_:
                z = jnp.where(is_last, a, False).astype(jnp.int32)
                return jax.lax.psum(z, axis) > 0
            z = jnp.where(is_last, a, jnp.zeros_like(a))
            return jax.lax.psum(z, axis)

        return jax.tree.map(replicate, PPWindowResult(*final))

    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(P(), P(), P()), out_specs=P(),
                       check_vma=False)
    return jax.jit(fn)(xyz, intensity, valid)
