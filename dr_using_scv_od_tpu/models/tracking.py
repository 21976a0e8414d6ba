"""SCV-OD tracking & dynamic detection.

Array-program re-design of `SSC::tracking` (src/ssc.cpp:1250-1426), the heart
of the method: a previous frame's car cluster is DYNAMIC iff its curved-
voxel footprint, re-projected into the next frame's grid with the relative
pose, fails to re-occupy (>= `occupancy`) a car cluster there.

The reference's per-cluster loop with per-point hash probes becomes:
  1. transform ALL prev car-cluster points with one matmul;
  2. re-quantize them into the next frame's curved grid (ops/quantize.py);
  3. deduplicate (prev_cluster, voxel) pairs by one sort (the reference
     calls sampleVec per cluster, src/ssc.cpp:1320-1321);
  4. one scatter-add builds the full contingency matrix
     cont[c, l] = #distinct next-voxels of next-cluster l hit by prev
     cluster c (the reference's `remap_name`, src/ssc.cpp:1304-1316);
  5. the verdict lattice (0 / 1 / >1 hit labels x occupancy ratio x target
     type, src/ssc.cpp:1323-1421) evaluates vectorized over all clusters,
     and the split/merge mutations of the next frame apply as scatter
     updates on its dense label grid.

Mutation-order semantics: the reference mutates `frame_next` inside the
cluster loop, so later clusters can observe earlier clusters' edits; here
all verdicts read the pre-mutation state and conflicting edits resolve by
minimum prev-cluster row (deterministic; SURVEY.md section 7.3 bounds the
accepted metric delta).

Tracking across a window is a Markov recurrence (pair t,t+1 only,
src/ssc.cpp:1450-1452) -> implemented as `lax.scan` whose carry is the
(possibly mutated) next-frame cluster table + label grid + track-id counter.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..types import (STATE_DYNAMIC, STATE_STATIC, TYPE_CAR, ClusterTable)
from ..ops import geometry, quantize, segment_ops

_INT_MAX = jnp.iinfo(jnp.int32).max


class TrackingResult(NamedTuple):
    tables: ClusterTable       # [F, C] finalized (states, track ids, merges)
    label_grids: jnp.ndarray   # [F, G] mutated label grids
    point_cluster: jnp.ndarray  # [F, N] final per-point cluster ids (the
    #                             prev-side lookup each pair already pays;
    #                             returning it saves the caller an [N]-
    #                             from-[G] re-gather per frame)
    n_dynamic: jnp.ndarray     # [F] int32 dynamic verdicts per pair
    new_row_overflow: jnp.ndarray    # scalar int32 - ran out of cluster rows
    track_point_overflow: jnp.ndarray  # scalar int32 - points past the
    #                                    max_track_points budget (distinct
    #                                    remediation: raise max_track_points)
    counter: jnp.ndarray       # scalar int32 - next unassigned track id
    #                            (streaming carry across windows)


def _pair_step(prev_table: ClusterTable, prev_grid: jnp.ndarray,
               next_table: ClusterTable, next_grid: jnp.ndarray,
               prev_xyz: jnp.ndarray, prev_point_voxel: jnp.ndarray,
               prev_valid: jnp.ndarray,
               T_np: jnp.ndarray, counter: jnp.ndarray,
               cfg: PipelineConfig, occupancy: jnp.ndarray | None = None):
    """One tracking pair. Returns (prev_table_final, next_table_mut,
    next_grid_mut, counter, n_dynamic, overflow)."""
    C = cfg.shapes.max_clusters
    G = cfg.grid.bin_num

    # ---- fresh track ids for untracked prev car clusters (ssc.cpp:1266-71)
    is_car_row = prev_table.valid & (prev_table.type == TYPE_CAR)
    needs_tid = is_car_row & (prev_table.track_id == -1)
    tid_rank = jnp.cumsum(needs_tid.astype(jnp.int32)) - 1
    track_id = jnp.where(needs_tid, counter + tid_rank, prev_table.track_id)
    counter = counter + jnp.sum(needs_tid)
    prev_table = prev_table.replace(track_id=track_id)

    # ---- project prev car points into next frame's curved grid
    pv_safe = jnp.clip(prev_point_voxel, 0, G - 1)
    pc = jnp.where(prev_valid & (prev_point_voxel >= 0),
                   prev_grid[pv_safe], -1)
    pc_full = pc                  # final per-point clusters of prev frame
    pc_safe = jnp.clip(pc, 0, C - 1)
    # per-point car flag via the select tree instead of an [N]-shaped
    # gather from the C-row table (segment_ops.small_table_lookup)
    pt_car = (pc >= 0) & segment_ops.small_table_lookup(
        is_car_row, pc_safe, 1)

    # ---- compact car points into a fixed small budget: only car-cluster
    # points are judged (ssc.cpp:1255-1275), and they are a small fraction
    # of a scan - the dedup sort below runs over K slots instead of N
    # points (the N-sized sort dominated tracking cost).
    # When the budget binds, points are UNIFORMLY STRIDED over scan order
    # rather than first-K truncated: striding keeps every cluster's share
    # proportional to its size (the reference judges every car point,
    # ssc.cpp:1255-1275; first-K starved late-scan clusters of coverage and
    # biased their overlap ratio toward DYNAMIC).
    K = cfg.shapes.max_track_points
    N = prev_xyz.shape[0]
    rank = jnp.cumsum(pt_car.astype(jnp.int32)) - 1
    total = jnp.sum(pt_car)
    stride = jnp.maximum((total + K - 1) // K, 1)
    sel = pt_car & (rank % stride == 0)
    # slot k <- the (k+1)-th selected point, found by binary search on the
    # inclusive selection count (three [N]-update scatters used to live
    # here; searchsorted is log2(N) gathers of [K])
    csel = jnp.cumsum(sel.astype(jnp.int32))
    idx = jnp.searchsorted(csel, jnp.arange(1, K + 1, dtype=csel.dtype),
                           side="left").astype(jnp.int32)
    ccar = jnp.arange(K, dtype=jnp.int32) < jnp.minimum(csel[-1], K)
    idx_safe = jnp.clip(idx, 0, N - 1)
    cxyz = jnp.where(ccar[:, None], prev_xyz[idx_safe], 0.0)
    cpc = jnp.where(ccar, pc[idx_safe], -1)
    track_overflow = total - jnp.sum(ccar)

    warped = geometry.transform_points(T_np, cxyz)
    _, vflat, in_fov = quantize.quantize(warped, ccar, cfg.grid)
    v_safe = jnp.clip(vflat, 0, G - 1)
    nlab = jnp.where(in_fov, next_grid[v_safe], -1)
    hit = in_fov & (nlab >= 0)
    pc = cpc

    # a cluster whose points ALL fell past the K budget must stay unjudged
    # (letting it fall into the n_labels==0 branch would wrongly mark it
    # dynamic - the reference judges every car cluster with all its points)
    has_budgeted_pt = jnp.zeros((C,), bool).at[
        jnp.clip(cpc, 0, C - 1)].max(ccar & (cpc >= 0))
    # ratio stability under forced subsampling: a 1-in-stride sample only
    # preserves a cluster's voxel COVERAGE (hence its overlap ratio) when
    # the cluster averages >= stride points per occupied voxel; sparser
    # clusters would see a deflated hit count and drift toward DYNAMIC on
    # partial evidence, so they stay unjudged (overflow counter reports
    # the skipped points). No-op when the budget does not bind (stride 1).
    sufficient = (stride <= 1) | (
        prev_table.n_points >= stride * jnp.maximum(prev_table.n_voxels, 1))

    # ---- dedup (prev cluster, voxel) pairs: one sort (ssc.cpp:1320-1321)
    key = jnp.where(hit, pc * G + vflat, _INT_MAX)
    order = jnp.argsort(key)
    skey = key[order]
    uniq = jnp.concatenate([jnp.ones((1,), bool), skey[1:] != skey[:-1]]) \
        & (skey != _INT_MAX)
    u_c = jnp.where(uniq, pc[order], C)          # [N] pair cluster (C=pad)
    u_v = jnp.where(uniq, v_safe[order], 0)
    u_l = jnp.where(uniq, nlab[order], C)

    # ---- contingency cont[c, l] = #distinct voxels (ssc.cpp:1304-1336)
    cont = jnp.zeros((C + 1, C + 1), jnp.int32)
    cont = cont.at[u_c, u_l].add(jnp.where(uniq, 1, 0))
    cont = cont[:C, :C]

    nvox_next = jnp.maximum(next_table.n_voxels, 1).astype(jnp.float32)
    ratio = cont.astype(jnp.float32) / nvox_next[None, :]

    hit_any = cont > 0
    n_labels = jnp.sum(hit_any, axis=1)
    lstar = jnp.argmax(cont, axis=1)             # the single label if n==1
    lstar_safe = jnp.clip(lstar, 0, C - 1)
    ratio1 = ratio[jnp.arange(C), lstar_safe]
    lstar_is_car = next_table.type[lstar_safe] == TYPE_CAR

    # the occupancy threshold is a SCALAR compare in the verdict lattice,
    # so it may be a traced override (eval/sweep.py vmaps the whole
    # window over a threshold axis - one compile for the entire sweep)
    occ = cfg.track.occupancy if occupancy is None else occupancy
    # only car clusters WITH at least one surviving budgeted point AND
    # coverage-preserving sampling are judged; budget-truncated clusters
    # keep their prior state
    active = is_car_row & has_budgeted_pt & sufficient

    # verdict lattice (ssc.cpp:1323-1421)
    verdict_dyn = active & ((n_labels == 0)
                            | ((n_labels == 1) & (ratio1 < occ)
                               & lstar_is_car))
    is_split = active & (n_labels == 1) & (ratio1 < occ) & ~lstar_is_car
    is_absorb = active & (n_labels == 1) & (ratio1 >= occ) & lstar_is_car
    is_merge = active & (n_labels > 1)
    qual = (is_merge[:, None] & hit_any
            & (next_table.type[None, :] == TYPE_CAR) & (ratio >= occ))
    merge_has_rows = jnp.any(qual, axis=1)

    state = prev_table.state
    state = jnp.where(verdict_dyn, STATE_DYNAMIC, state)
    state = jnp.where(is_split | is_merge
                      | is_absorb, STATE_STATIC, state)
    # split: prev cluster adopts the target's type (ssc.cpp:1354)
    new_prev_type = jnp.where(is_split, next_table.type[lstar_safe],
                              prev_table.type)
    prev_table = prev_table.replace(state=state, type=new_prev_type)

    # ---- allocate next-frame rows for splits and merges
    needs_new = is_split | (is_merge & merge_has_rows)
    new_rank = jnp.cumsum(needs_new.astype(jnp.int32)) - 1
    free = ~next_table.valid
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
    rank_to_row = jnp.full((C,), -1, jnp.int32)
    rank_to_row = rank_to_row.at[
        jnp.where(free, free_rank, C - 1)].max(
        jnp.where(free, jnp.arange(C, dtype=jnp.int32), -1))
    n_free = jnp.sum(free)
    got_row = needs_new & (new_rank < n_free)
    new_row = jnp.where(got_row,
                        rank_to_row[jnp.clip(new_rank, 0, C - 1)], C)
    got_row = got_row & (new_row >= 0) & (new_row < C)
    overflow = jnp.sum(needs_new & ~got_row)
    new_row = jnp.where(got_row, new_row, C)

    if not cfg.track.enable_compensation:
        # "-TC" ablation: verdicts only, no next-frame mutations
        return (prev_table, next_table, next_grid, counter,
                jnp.sum(verdict_dyn).astype(jnp.int32),
                jnp.zeros((), jnp.int32),
                track_overflow.astype(jnp.int32), pc_full)

    # ---- apply split: carve hit voxels of lstar into the new row
    # (ssc.cpp:1355-1374); conflicts resolve to the min new row
    pair_split = (u_c < C) & is_split[jnp.clip(u_c, 0, C - 1)] \
        & (u_l == lstar_safe[jnp.clip(u_c, 0, C - 1)]) \
        & got_row[jnp.clip(u_c, 0, C - 1)]
    carve = jnp.full((G,), _INT_MAX, jnp.int32)
    carve = carve.at[u_v].min(
        jnp.where(pair_split, new_row[jnp.clip(u_c, 0, C - 1)], _INT_MAX))
    next_grid_mut = jnp.where(carve != _INT_MAX, carve, next_grid)

    # ---- apply merge: absorb qualifying car rows into the new row
    # (ssc.cpp:1396-1421); a row claimed by several prev clusters goes to
    # the minimum new row
    claim = jnp.where(qual & got_row[:, None], new_row[:, None], _INT_MAX)
    absorb = jnp.min(claim, axis=0)              # [C] target row or INT_MAX
    lab_safe = jnp.clip(next_grid_mut, 0, C - 1)
    # row -> target-row relabel over the [G] grid via the select tree
    # (encode "not absorbed" as C) instead of a [G]-shaped gather from
    # the C-row table
    bits = max((C + 1).bit_length(), 1)
    absorb_enc = jnp.where(absorb == _INT_MAX, C, absorb)
    lut = segment_ops.small_table_lookup(absorb_enc, lab_safe, bits)
    absorbed_to = jnp.where((next_grid_mut >= 0) & (lut < C), lut,
                            _INT_MAX)
    next_grid_mut = jnp.where(absorbed_to != _INT_MAX, absorbed_to,
                              next_grid_mut)

    # ---- build mutated next table
    new_is_row = jnp.full((C,), False)
    new_is_row = new_is_row.at[jnp.clip(new_row, 0, C - 1)].max(got_row)
    # type of new rows: split -> target's type; merge -> car (ssc.cpp:1357-59,1402)
    new_type_src = jnp.where(is_split, next_table.type[lstar_safe], TYPE_CAR)
    new_type = jnp.full((C,), -1, jnp.int32)
    new_type = new_type.at[jnp.clip(new_row, 0, C - 1)].max(
        jnp.where(got_row, new_type_src, -1))
    new_tid = jnp.full((C,), -1, jnp.int32)
    new_tid = new_tid.at[jnp.clip(new_row, 0, C - 1)].max(
        jnp.where(got_row, prev_table.track_id, -1))

    merged_away = absorb != _INT_MAX
    valid_next = (next_table.valid & ~merged_away) | new_is_row
    type_next = jnp.where(new_is_row, new_type, next_table.type)
    tid_next = jnp.where(new_is_row, new_tid, next_table.track_id)
    # absorb branch with ratio >= occ & car: propagate track id (ssc.cpp:1381)
    prop = jnp.full((C,), _INT_MAX, jnp.int32)
    prop = prop.at[jnp.where(is_absorb, lstar_safe, C - 1)].min(
        jnp.where(is_absorb, prev_table.track_id, _INT_MAX))
    tid_next = jnp.where((prop != _INT_MAX) & ~new_is_row, prop, tid_next)

    # recompute per-row voxel counts from the mutated grid (outer-product
    # histogram matmul instead of a [G]-sized scatter)
    nvox = segment_ops.grid_label_counts(next_grid_mut, C)
    valid_next = valid_next & ((nvox > 0) | ~next_table.valid | new_is_row)

    next_table_mut = next_table.replace(
        valid=valid_next, type=type_next, track_id=tid_next, n_voxels=nvox)
    n_dyn = jnp.sum(verdict_dyn).astype(jnp.int32)
    return (prev_table, next_table_mut, next_grid_mut, counter, n_dyn,
            overflow.astype(jnp.int32), track_overflow.astype(jnp.int32),
            pc_full)


def track_window(xyz: jnp.ndarray, point_voxel: jnp.ndarray,
                 point_valid: jnp.ndarray, label_grids: jnp.ndarray,
                 tables: ClusterTable, poses: jnp.ndarray,
                 cfg: PipelineConfig,
                 init_carry=None,
                 occupancy: jnp.ndarray | None = None) -> TrackingResult:
    """Run tracking over a window of F frames (scan over pairs,
    src/ssc.cpp:1450-1452).

    Args are stacked along the frame axis: xyz [F,N,3], point_voxel [F,N],
    point_valid [F,N], label_grids [F,G], tables [F,C], poses [F,4,4].

    `init_carry` (streaming): optional (table, label_grid, counter) of the
    window's FIRST frame as mutated by the previous window (the engine
    overlaps windows by one frame so track ids and split/merge compensation
    stay continuous across window boundaries). Defaults to the first
    frame's freshly segmented state with counter 0.
    """
    F = xyz.shape[0]

    def at(tree, i):
        return jax.tree.map(
            lambda a: jax.lax.dynamic_index_in_dim(a, i, 0, keepdims=False),
            tree)

    def step(carry, t):
        cur_table, cur_grid, counter, ovf, tovf = carry
        nxt_table = at(tables, t + 1)
        nxt_grid = label_grids[t + 1]
        T_np = geometry.matmul(geometry.inverse_se3(poses[t + 1]), poses[t])
        (prev_fin, nxt_mut, nxt_grid_mut, counter, n_dyn, o, to, pc) = \
            _pair_step(
                cur_table, cur_grid, nxt_table, nxt_grid,
                xyz[t], point_voxel[t], point_valid[t],
                T_np, counter, cfg, occupancy)
        return ((nxt_mut, nxt_grid_mut, counter, ovf + o, tovf + to),
                (prev_fin, cur_grid, n_dyn, pc))

    if init_carry is None:
        t0, g0, c0 = at(tables, 0), label_grids[0], jnp.zeros((), jnp.int32)
    else:
        t0, g0, c0 = init_carry
    init = (t0, g0, c0,
            jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
    ((last_table, last_grid, counter, overflow, track_overflow),
     (fin_tables, fin_grids, n_dyn, fin_pc)) = \
        jax.lax.scan(step, init, jnp.arange(F - 1))

    # append the final frame (its clusters get no verdicts - same as the
    # reference, whose last frame is never a tracking 'prev')
    all_tables = jax.tree.map(
        lambda a, b: jnp.concatenate([a, b[None]], axis=0),
        fin_tables, last_table)
    all_grids = jnp.concatenate([fin_grids, last_grid[None]], axis=0)
    n_dyn = jnp.concatenate([n_dyn, jnp.zeros((1,), jnp.int32)])
    # the last frame's per-point clusters: the one [N]-from-[G] gather the
    # scan did not already pay
    G = last_grid.shape[0]
    pv_last = jnp.clip(point_voxel[F - 1], 0, G - 1)
    pc_last = jnp.where(point_valid[F - 1] & (point_voxel[F - 1] >= 0),
                        last_grid[pv_last], -1)
    all_pc = jnp.concatenate([fin_pc, pc_last[None]], axis=0)
    return TrackingResult(tables=all_tables, label_grids=all_grids,
                          point_cluster=all_pc,
                          n_dynamic=n_dyn, new_row_overflow=overflow,
                          track_point_overflow=track_overflow,
                          counter=counter)
