"""Multi-frame object-map initialization.

Implements the reference's designed-but-dead `SSC::intialization`
(src/ssc.cpp:1148-1248; declared in the flow by `mapping_init` but never
invoked - SURVEY.md section 3.5 directs us to build it as the map
bootstrap stage): pick the frame with the fewest clusters as the base,
project every other frame's clusters into the base curved-voxel grid via
relative poses, and fuse base clusters that one foreign cluster co-occupies
with >= `occupancy` voxel-overlap ratio.

Same formulation as tracking: sort-dedup of (cluster, voxel) pairs +
one scatter-add contingency matrix per frame, fused over a `lax.scan`.
Conflicting fusions resolve to the minimum base row (deterministic;
the reference's in-loop mutation order is not reproducible anyway).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..ops import geometry, quantize
from ..types import ClusterTable

_INT_MAX = jnp.iinfo(jnp.int32).max


class ObjectMapResult(NamedTuple):
    base_idx: jnp.ndarray       # scalar int32 - chosen base frame
    label_grid: jnp.ndarray     # [G] fused base label grid
    table: ClusterTable         # fused base cluster table
    n_fused: jnp.ndarray        # scalar int32 - clusters removed by fusion


def initialize(xyz: jnp.ndarray, point_voxel: jnp.ndarray,
               point_valid: jnp.ndarray, label_grids: jnp.ndarray,
               tables: ClusterTable, poses: jnp.ndarray,
               cfg: PipelineConfig) -> ObjectMapResult:
    """Fuse an init window ([F, ...] stacked per-frame outputs) into an
    object-level base map."""
    F = xyz.shape[0]
    C = cfg.shapes.max_clusters
    G = cfg.grid.bin_num

    n_clusters = jnp.sum(tables.valid, axis=1)
    # reference picks min cluster count, ties -> later frame (<=, :1154)
    base = jnp.argmin(jnp.flip(n_clusters))
    base = (F - 1 - base).astype(jnp.int32)

    def at(tree, i):
        return jax.tree.map(
            lambda a: jax.lax.dynamic_index_in_dim(a, i, 0, keepdims=False),
            tree)

    base_grid0 = label_grids[base]
    base_pose_inv = geometry.inverse_se3(poses[base])

    def step(carry, i):
        base_grid, merge_count = carry
        is_base = i == base
        T_bi = geometry.matmul(base_pose_inv, poses[i])

        pv = point_voxel[i]
        pvalid = point_valid[i] & (pv >= 0)
        pc = jnp.where(pvalid, label_grids[i][jnp.clip(pv, 0, G - 1)], -1)
        warped = geometry.transform_points(T_bi, xyz[i])
        _, vflat, in_fov = quantize.quantize(warped, pvalid & (pc >= 0),
                                             cfg.grid)
        v_safe = jnp.clip(vflat, 0, G - 1)
        blab = jnp.where(in_fov, base_grid[v_safe], -1)
        hit = in_fov & (blab >= 0) & ~is_base

        key = jnp.where(hit, pc * G + vflat, _INT_MAX)
        order = jnp.argsort(key)
        skey = key[order]
        uniq = jnp.concatenate([jnp.ones((1,), bool),
                                skey[1:] != skey[:-1]]) & (skey != _INT_MAX)
        u_c = jnp.where(uniq, pc[order], C)
        u_l = jnp.where(uniq, blab[order], C)

        cont = jnp.zeros((C + 1, C + 1), jnp.int32)
        cont = cont.at[u_c, u_l].add(jnp.where(uniq, 1, 0))
        cont = cont[:C, :C]

        base_nvox = jax.ops.segment_sum(
            (base_grid >= 0).astype(jnp.int32),
            jnp.where(base_grid >= 0, base_grid, C),
            num_segments=C + 1)[:C]
        ratio = cont / jnp.maximum(base_nvox, 1)[None, :].astype(jnp.float32)

        qual = (cont > 0) & (ratio >= cfg.track.occupancy)
        n_hit = jnp.sum(cont > 0, axis=1)
        fuse_row = (n_hit > 1)                       # remap_name.size() > 1
        qual = qual & fuse_row[:, None]
        # fuse all base labels claimed by one foreign cluster into the
        # minimum claimed base label
        claimed = jnp.any(qual, axis=0)
        target = jnp.where(
            qual, jnp.arange(C, dtype=jnp.int32)[None, :], _INT_MAX)
        row_min = jnp.min(target, axis=1)            # [C] min base per c
        fuse_to = jnp.full((C,), _INT_MAX, jnp.int32)
        fuse_to = jnp.min(jnp.where(qual, row_min[:, None], _INT_MAX),
                          axis=0)                    # [C] per base label
        do = (fuse_to != _INT_MAX) & claimed
        mapping = jnp.where(do, fuse_to, jnp.arange(C, dtype=jnp.int32))
        # transitive closure (short chains): two folds
        mapping = mapping[mapping]
        mapping = mapping[mapping]
        merged = jnp.sum(mapping != jnp.arange(C))
        new_grid = jnp.where(base_grid >= 0,
                             mapping[jnp.clip(base_grid, 0, C - 1)],
                             base_grid)
        return (new_grid, merge_count + merged), None

    (fused_grid, n_fused), _ = jax.lax.scan(
        step, (base_grid0, jnp.zeros((), jnp.int32)), jnp.arange(F))

    # rebuild base table from the fused grid
    base_table = at(tables, base)
    gv = fused_grid >= 0
    nvox = jax.ops.segment_sum(gv.astype(jnp.int32),
                               jnp.where(gv, fused_grid, C),
                               num_segments=C + 1)[:C]
    valid = base_table.valid & (nvox > 0)
    table = base_table.replace(valid=valid, n_voxels=nvox)
    return ObjectMapResult(base_idx=base, label_grid=fused_grid,
                           table=table, n_fused=n_fused)
