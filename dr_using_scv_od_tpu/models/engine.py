"""The composed dynamic-aware LiDAR odometry & mapping engine.

This is the sequence driver the reference aspired to but left commented
out (the map-accumulation + GICP + final-evaluation block of segDF,
src/ssc.cpp:1454-1546): a STREAMING loop that takes raw scans - no poses -
and produces a clean static map plus an optimized trajectory. Per window
of W scans (overlapping the previous window by one frame so tracking and
track ids stay continuous):

  1. GICP scan-to-map odometry against a local map built from the last
     `local_map_kf` keyframes' STATIC submaps (dynamic-removed
     registration - feedback the reference never had). The window is
     registered in REFRESH CHUNKS: the (coarse, fine) GICP targets are
     finalized once per chunk and the chunk's scans register against the
     frozen targets (pure Gauss-Newton), then the chunk's warped points
     merge into the map in ONE wide scatter (per-scan map
     rebuild+refinalize was most of the engine's odometry cost on the
     previous accelerator; not yet measured on the H100);
  2. KEYFRAME SELECTION: a scan becomes a keyframe when it has moved
     >= kf_dist metres or rotated >= kf_rot radians since the last
     keyframe (the arbitrary-window driver loop of src/ssc.cpp:1435-1445
     generalized to unbounded sequences). Non-keyframe scans still
     register, still get tracked and judged, and top up the submap of
     their assigned (most recent) keyframe - they just don't consume a
     pose/descriptor/submap slot, so the fixed K budget covers an
     arbitrarily long trajectory. Thresholds <= 0 (the default) disable
     gating: every scan is a keyframe, the round-4 behavior;
  3. segmentation + SCV-OD tracking (models/pipeline.run_window) with the
     estimated poses and the streaming tracking carry;
  4. judged frames contribute their static points to keyframe-local
     submaps (fixed budget P per keyframe, cursor-based top-up; world
     map = submaps warped by the CURRENT pose estimates, so pose-graph
     corrections re-anchor the whole map for free);
  5. loop-closure retrieval by the pooled SCV-OD occupancy descriptor
     (models/scan_context.py - pose-estimate independent): the window's
     descriptors are computed ONCE and reused for both the keyframe bank
     and the queries; the TOP-K distinct candidates are GICP-verified
     (each behind its own lax.cond, so sub-threshold scores cost
     nothing), with the descriptor's yaw as warm start;
  6. pose-graph optimization (models/posegraph.py) whenever a loop edge
     is accepted;
  7. periodic ERASOR cleaning of the accumulated map (models/erasor.py)
     and periodic checkpoints (utils/checkpoint.py) with exact resume.

On per-keyframe GICP voxel-map caching (merging cached per-keyframe
VoxelMaps instead of rebuilding the local map): submaps are keyframe-LOCAL and
get re-anchored by the latest pose estimates every window, and a voxel
grid cannot be rigidly transformed (bins don't rotate) - cached sums are
additive only in a shared frame, which PGO keeps moving. The refresh-
chunk restructure above attacks the same cost (target refinalization +
per-scan rebuilds) without freezing poses into cached grids.

All state lives in one fixed-shape pytree (`EngineState`), so a window
step is a single jitted function and a checkpoint is a flat array dict.
Keyframe-table writes are scatters with mode='drop': past the K budget
nothing is silently overwritten - dropped keyframes are counted in
`kf_overflow` and surfaced as a hard error by the host driver.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..config import PipelineConfig
from ..ops import geometry
from ..types import ClusterTable, pytree_dataclass
from . import erasor as erasor_mod
from . import gicp, pipeline, posegraph, scan_context


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    window: int = 8              # scans per processing window (>= 3)
    max_keyframes: int = 128     # K: pose / submap / descriptor budget
    submap_points: int = 4096    # P: static points kept per keyframe
    local_map_kf: int = 3        # keyframes in the odometry local map
    # keyframe selection gates (<= 0 disables that gate; both disabled =
    # every scan is a keyframe)
    kf_dist: float = 0.0         # metres moved since the last keyframe
    kf_rot: float = 0.0          # radians rotated since the last keyframe
    # odometry map refresh cadence: scans registered per frozen-target
    # chunk before the map is rebuilt/refinalized (higher = cheaper,
    # coarser within-window map)
    odo_refresh_every: int = 2
    desc: scan_context.DescriptorConfig = dataclasses.field(
        default_factory=scan_context.DescriptorConfig)
    # loop closure
    loop_min_gap: int = 8        # minimum keyframe separation
    loop_min_score: float = 0.92  # descriptor similarity floor
    loop_top_k: int = 3          # distinct candidates GICP-verified/window
    loop_min_corr_frac: float = 0.15
    loop_max_rmse: float = 0.6
    loop_edge_weight: float = 3.0
    max_loop_edges: int = 32
    # pose graph
    pgo_gn_iters: int = 8
    pgo_cg_iters: int = 32
    # map cleaning
    erasor: erasor_mod.ErasorConfig = dataclasses.field(
        default_factory=erasor_mod.ErasorConfig)
    erasor_every: int = 0        # windows between ERASOR passes; 0 = final only
    # fault injection (drift studies / loop-closure tests): an se(3) bias
    # composed onto every odometry relative transform, simulating a
    # miscalibrated or drifting front end. The loop-closure measurements
    # come from GICP on the actual scans and are NOT biased.
    drift_bias: Tuple[float, ...] = (0.0,) * 6


@pytree_dataclass
class EngineState:
    n: jnp.ndarray               # int32 - KEYFRAMES so far
    frames: jnp.ndarray          # int32 - scans processed so far
    poses: jnp.ndarray           # [K,4,4] current world_T_k estimates
    rel_T: jnp.ndarray           # [K,4,4] keyframe odometry (k-1)_T_k;
    #                              row 0 unused
    kf_frame: jnp.ndarray        # [K] int32 scan id of keyframe k (-1 unused)
    last_pose: jnp.ndarray       # [4,4] pose of the last processed scan
    last_rel: jnp.ndarray        # [4,4] last scan-to-scan relative motion
    #                              (constant-velocity warm start)
    submap_xyz: jnp.ndarray      # [K,P,3] static points, keyframe-LOCAL
    submap_valid: jnp.ndarray    # [K,P]
    submap_idx: jnp.ndarray      # [K,P] source point index in the scan
    #                              that contributed slot p (-1 = unused)
    submap_frame: jnp.ndarray    # [K,P] scan id that contributed slot p -
    #                              with (submap_idx, submap_frame) every
    #                              map point ties back to its GT label for
    #                              exact map-level PR/RR
    submap_fill: jnp.ndarray     # [K] int32 write cursor per keyframe
    desc: jnp.ndarray            # [K,R,S] place-recognition descriptors
    loop_i: jnp.ndarray          # [L] int32 (-1 = unused)
    loop_j: jnp.ndarray          # [L]
    loop_T: jnp.ndarray          # [L,4,4] measured i_T_j
    loop_w: jnp.ndarray          # [L]
    n_loops: jnp.ndarray         # int32
    # streaming tracking carry (boundary frame of the last window)
    track_table: ClusterTable
    track_grid: jnp.ndarray      # [G]
    track_counter: jnp.ndarray   # int32
    # accumulated diagnostics (overflow discipline)
    row_overflow: jnp.ndarray
    point_overflow: jnp.ndarray
    submap_overflow: jnp.ndarray  # a keyframe's OWN static points past P
    kf_overflow: jnp.ndarray      # keyframes dropped past the K budget
    erasor_removed: jnp.ndarray   # map points ERASOR invalidated
    odo_fallbacks: jnp.ndarray    # registrations that fell back to the
    #                               constant-velocity prior


class WindowOutput(NamedTuple):
    removed: jnp.ndarray         # [W-1,N] verdicts for judged frames
    poses: jnp.ndarray           # [W,4,4] window SCAN poses (post-odometry)
    n_dynamic: jnp.ndarray       # [W]
    odo_n_corr: jnp.ndarray      # [W-1]
    odo_rmse: jnp.ndarray        # [W-1]
    is_kf: jnp.ndarray           # [W] bool - scan became a keyframe
    kf_slot: jnp.ndarray         # [W] int32 - assigned keyframe slot
    loop_accepted: jnp.ndarray   # [k] bool - loop edges landed this window
    loop_pair: jnp.ndarray       # [k,2] int32 (i, j) or (-1, -1)
    loop_score: jnp.ndarray      # [k] descriptor similarity of candidates
    loop_rmse: jnp.ndarray       # [k] GICP verification residual (inf)
    loop_ncorr: jnp.ndarray      # [k] GICP verification correspondences
    pgo_error: jnp.ndarray       # final PGO residual (0 if not run)


def _empty_table(cfg: PipelineConfig) -> ClusterTable:
    C = cfg.shapes.max_clusters
    return ClusterTable(
        valid=jnp.zeros((C,), bool),
        n_points=jnp.zeros((C,), jnp.int32),
        n_voxels=jnp.zeros((C,), jnp.int32),
        bbox_min=jnp.zeros((C, 3), jnp.float32),
        bbox_max=jnp.zeros((C, 3), jnp.float32),
        type=jnp.full((C,), -1, jnp.int32),
        state=jnp.full((C,), -1, jnp.int32),
        track_id=jnp.full((C,), -1, jnp.int32))


def init_state(ec: EngineConfig, cfg: PipelineConfig) -> EngineState:
    K, P, L = ec.max_keyframes, ec.submap_points, ec.max_loop_edges
    R, S = ec.desc.rings, ec.desc.sectors
    eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (K, 4, 4))
    return EngineState(
        n=jnp.zeros((), jnp.int32),
        frames=jnp.zeros((), jnp.int32),
        poses=eye, rel_T=eye,
        kf_frame=jnp.full((K,), -1, jnp.int32),
        last_pose=jnp.eye(4, dtype=jnp.float32),
        last_rel=jnp.eye(4, dtype=jnp.float32),
        submap_xyz=jnp.zeros((K, P, 3), jnp.float32),
        submap_valid=jnp.zeros((K, P), bool),
        submap_idx=jnp.full((K, P), -1, jnp.int32),
        submap_frame=jnp.full((K, P), -1, jnp.int32),
        submap_fill=jnp.zeros((K,), jnp.int32),
        desc=jnp.zeros((K, R, S), jnp.float32),
        loop_i=jnp.full((L,), -1, jnp.int32),
        loop_j=jnp.full((L,), -1, jnp.int32),
        loop_T=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (L, 4, 4)),
        loop_w=jnp.zeros((L,), jnp.float32),
        n_loops=jnp.zeros((), jnp.int32),
        track_table=_empty_table(cfg),
        track_grid=jnp.full((cfg.grid.bin_num,), -1, jnp.int32),
        track_counter=jnp.zeros((), jnp.int32),
        row_overflow=jnp.zeros((), jnp.int32),
        point_overflow=jnp.zeros((), jnp.int32),
        submap_overflow=jnp.zeros((), jnp.int32),
        kf_overflow=jnp.zeros((), jnp.int32),
        erasor_removed=jnp.zeros((), jnp.int32),
        odo_fallbacks=jnp.zeros((), jnp.int32))


# ---------------------------------------------------------------------------
# odometry


def _window_odometry(state: EngineState, xyz, valid, first: bool,
                     ec: EngineConfig, cfg: PipelineConfig):
    """Scan-to-map GICP over one window, in the coordinate frame of the
    window's first scan (frame A) - so the Cartesian voxel bounds of
    GicpConfig never clip, however far the world trajectory drifts.

    Refresh-chunk structure: the (coarse, fine) GICP targets are
    finalized once per `odo_refresh_every` scans; the chunk's scans
    register against the FROZEN targets (registration is then pure
    Gauss-Newton - no per-scan map build or [G]-wide refinalization),
    and the chunk's ok-registered warped points merge into the running
    VoxelMap in one batched wide scatter before the next chunk's
    refresh. The final chunk skips the merge (no later consumer).

    Returns (A_T_t [W,4,4], n_corr [W-1], rmse [W-1], pose_A, n_fallback).
    """
    W = xyz.shape[0]
    pose_A = jnp.eye(4, dtype=xyz.dtype) if first else state.last_pose
    A_inv = geometry.inverse_se3(pose_A)

    # local map: static submaps of the last `local_map_kf` keyframes,
    # re-anchored into frame A by the CURRENT pose estimates
    vm = gicp.build_voxel_map(xyz[0], valid[0], cfg.gicp)
    if not first:
        Kn = ec.local_map_kf
        start = jnp.clip(state.n - Kn, 0, ec.max_keyframes - Kn)
        sm = jax.lax.dynamic_slice_in_dim(state.submap_xyz, start, Kn, 0)
        sv = jax.lax.dynamic_slice_in_dim(state.submap_valid, start, Kn, 0)
        pk = jax.lax.dynamic_slice_in_dim(state.poses, start, Kn, 0)
        T_ak = jnp.einsum('ij,kjl->kil', A_inv, pk,
                          precision="highest")          # [Kn,4,4]
        local = jnp.einsum('kij,kpj->kpi', T_ak[:, :3, :3], sm,
                           precision="highest") \
            + T_ak[:, None, :3, 3]
        vm = vm.merge(gicp.build_voxel_map(
            local.reshape(-1, 3), sv.reshape(-1), cfg.gicp))

    if first:
        # cold start: no constant-velocity prior exists for the very first
        # pair - sweep yaw hypotheses through the coarse pyramid level
        # (gicp.register_global) and hand the winner to the scan step as
        # its warm start
        rel0 = gicp.register_global(xyz[1], valid[1], vm, cfg.gicp).T
    else:
        rel0 = state.last_rel

    chunk = max(int(ec.odo_refresh_every), 1)
    steps = list(range(1, W))
    T_prev = jnp.eye(4, dtype=xyz.dtype)
    rel_prev = rel0
    out_T, out_nc, out_rm, out_fell = [], [], [], []
    for c0 in range(0, len(steps), chunk):
        idxs = steps[c0:c0 + chunk]
        tgt_c, ccfg, tgt_f = gicp.build_targets(vm, cfg.gicp)

        def step_fn(carry, t, tgt_c=tgt_c, ccfg=ccfg, tgt_f=tgt_f):
            T_prev, rel_prev = carry
            T_init = geometry.matmul(T_prev, rel_prev)
            res = gicp.register_targets(xyz[t], valid[t], tgt_c, ccfg,
                                        tgt_f, cfg.gicp, T_init=T_init)
            # failure detection: registration that lost its
            # correspondences, went non-finite, or claims a physically
            # implausible jump falls back to the previous GOOD relative
            # transform (constant velocity) - error then grows linearly,
            # never compounds exponentially
            rel_cand = geometry.matmul(geometry.inverse_se3(T_prev), res.T)
            ok = (res.n_corr >= cfg.gicp.min_fallback_corr) \
                & jnp.all(jnp.isfinite(rel_cand)) \
                & (jnp.linalg.norm(rel_cand[:3, 3])
                   <= cfg.gicp.max_rel_motion)
            rel = jnp.where(ok, rel_cand, rel_prev)
            T_t = jnp.where(ok, res.T, geometry.matmul(T_prev, rel_prev))
            return (T_t, rel), (T_t, res.n_corr, res.rmse, ~ok, ok)

        (T_prev, rel_prev), (T_c, nc, rm, fell, oks) = jax.lax.scan(
            step_fn, (T_prev, rel_prev), jnp.asarray(idxs, jnp.int32))
        out_T.append(T_c)
        out_nc.append(nc)
        out_rm.append(rm)
        out_fell.append(fell)
        if c0 + chunk < len(steps):   # not the last chunk: refresh the map
            pts = xyz[idxs[0]:idxs[-1] + 1]              # [k,N,3]
            warped = jnp.einsum('kij,knj->kni', T_c[:, :3, :3], pts,
                                precision="highest") \
                + T_c[:, None, :3, 3]
            # a failed frame's points would pollute the map at a wrong
            # pose - keep them out
            ok_pts = valid[idxs[0]:idxs[-1] + 1] & oks[:, None]
            vm = vm.merge(gicp.build_voxel_map(
                warped.reshape(-1, 3), ok_pts.reshape(-1), cfg.gicp))

    A_T = jnp.concatenate(
        [jnp.eye(4, dtype=xyz.dtype)[None]] + out_T, axis=0)
    n_corr = jnp.concatenate(out_nc)
    rmse = jnp.concatenate(out_rm)
    n_fall = jnp.sum(jnp.concatenate(out_fell)).astype(jnp.int32)
    return A_T, n_corr, rmse, pose_A, n_fall


# ---------------------------------------------------------------------------
# keyframe selection


def _keyframe_gate(state: EngineState, poses_win, first: bool,
                   ec: EngineConfig):
    """Distance/rotation-gated keyframe selection over the window's scans.

    Returns (is_kf [W] bool, slot [W] int32 assigned keyframe slot,
    rel_kf [W,4,4] previous-keyframe -> this-scan edges, n_end).
    Non-keyframe scans are assigned to the most recent keyframe (their
    verdicts and submap points ride that slot). With both gates disabled
    every new scan is a keyframe - the fixed-window behavior."""
    W = poses_win.shape[0]
    n0 = state.n
    gating = (ec.kf_dist > 0.0) or (ec.kf_rot > 0.0)
    last_kf0 = jnp.where(first, jnp.eye(4, dtype=poses_win.dtype),
                         state.poses[jnp.maximum(n0 - 1, 0)])

    def step(carry, f):
        n_kf, last_pose = carry
        pose = poses_win[f]
        is_new = (f > 0) | jnp.asarray(bool(first))
        if gating:
            d = jnp.linalg.norm(pose[:3, 3] - last_pose[:3, 3])
            R = geometry.matmul(last_pose[:3, :3].T, pose[:3, :3])
            ang = jnp.arccos(jnp.clip((jnp.trace(R) - 1.0) * 0.5,
                                      -1.0, 1.0))
            hit = jnp.zeros((), bool)
            if ec.kf_dist > 0.0:
                hit = hit | (d >= ec.kf_dist)
            if ec.kf_rot > 0.0:
                hit = hit | (ang >= ec.kf_rot)
            hit = hit | (n_kf == 0)   # the run's first keyframe is forced
        else:
            hit = jnp.ones((), bool)
        is_kf = is_new & hit
        slot = jnp.where(is_kf, n_kf, jnp.maximum(n_kf - 1, 0))
        rel_kf = geometry.orthonormalize_se3(
            geometry.matmul(geometry.inverse_se3(last_pose), pose))
        return ((n_kf + is_kf.astype(jnp.int32),
                 jnp.where(is_kf, pose, last_pose)),
                (is_kf, slot, rel_kf))

    (n_end, _), (is_kf, slots, rel_kf) = jax.lax.scan(
        step, (n0, last_kf0), jnp.arange(W))
    return is_kf, slots, rel_kf, n_end


# ---------------------------------------------------------------------------
# loop closure


def _window_loops(state: EngineState, xyz, valid, descs, slots, is_kf,
                  first: bool, ec: EngineConfig, cfg: PipelineConfig):
    """Descriptor retrieval for every new KEYFRAME of the window; GICP-
    verify the top-k distinct (query, candidate) pairs, each behind its
    own lax.cond so sub-threshold scores never pay for a registration.
    Returns updated loop edge table fields + per-candidate diagnostics."""
    W = xyz.shape[0]
    K = ec.max_keyframes
    new0 = 0 if first else 1                # first new window-local frame
    Wq = W - new0

    q_slots = slots[new0:]
    bank_valid = jnp.arange(K)[None, :] <= (q_slots[:, None]
                                            - ec.loop_min_gap)

    def one_query(i):
        ret = scan_context.similarity(descs[new0 + i], state.desc,
                                      bank_valid[i])
        return ret.scores, ret.yaw

    scores, yaws = jax.lax.map(one_query, jnp.arange(Wq))   # [Wq,K]
    # only keyframe queries can carry a pose-graph edge
    scores = jnp.where(is_kf[new0:, None], scores, -jnp.inf)

    # top-k over the FULL (query, candidate) score matrix: one query
    # matching two distinct old keyframes contributes two edges (a
    # stronger graph constraint than one edge per query)
    k_loops = max(1, min(int(ec.loop_top_k), Wq * K))
    top_scores, top_flat = jax.lax.top_k(scores.reshape(-1), k_loops)
    top_q = top_flat // K
    top_cand = (top_flat % K).astype(jnp.int32)
    top_yaw = yaws.reshape(-1)[top_flat]
    top_qslot = q_slots[top_q]
    top_local = (top_q + new0).astype(jnp.int32)

    # greedy distinct-candidate selection among the top-k (two queries
    # retrieving the SAME candidate add no information; keep the higher)
    enabled = [jnp.ones((), bool)]
    for r in range(1, k_loops):
        distinct = jnp.ones((), bool)
        for s in range(r):
            distinct = distinct & (top_cand[r] != top_cand[s])
        enabled.append(distinct)

    def verify(cand, yaw, q_local):
        # register the candidate's sparse static submap (SOURCE, sensor
        # frame of c) against the dense query scan (TARGET, sensor frame
        # of q): the dense side must be the voxel map or most target
        # voxels fall below min_pts_per_voxel. Measured q_T_c, inverted
        # into the stored edge c_T_q. Warm start: the descriptor's yaw
        # (c_T_q ~ Rz(yaw)) inverted.
        sm = state.submap_xyz[cand]
        sv = state.submap_valid[cand]
        c, s = jnp.cos(-yaw), jnp.sin(-yaw)
        T_init = jnp.array([[c, -s, 0, 0], [s, c, 0, 0],
                            [0, 0, 1, 0], [0, 0, 0, 1]], xyz.dtype)
        res = gicp.scan_to_scan(sm, sv, xyz[q_local], valid[q_local],
                                cfg.gicp, T_init=T_init)
        # absolute floor: an empty candidate submap (e.g. fully
        # invalidated by ERASOR) would otherwise make min_corr = 0 and
        # let a zero-correspondence "registration" into the graph
        min_corr = jnp.maximum(
            ec.loop_min_corr_frac * jnp.sum(sv),
            jnp.asarray(cfg.gicp.min_fallback_corr, jnp.float32))
        ok = (res.n_corr >= min_corr) & (res.rmse < ec.loop_max_rmse)
        return geometry.inverse_se3(res.T), ok, res.rmse, res.n_corr

    li, lj = state.loop_i, state.loop_j
    lT, lw = state.loop_T, state.loop_w
    nl = state.n_loops
    acc_list, pair_list, rmse_list, ncorr_list = [], [], [], []
    for r in range(k_loops):
        propose = enabled[r] & (top_scores[r] >= ec.loop_min_score) \
            & (nl < ec.max_loop_edges)
        T_edge, ok, v_rmse, v_ncorr = jax.lax.cond(
            propose,
            lambda _: verify(top_cand[r], top_yaw[r], top_local[r]),
            lambda _: (jnp.eye(4, dtype=xyz.dtype), jnp.asarray(False),
                       jnp.asarray(jnp.inf), jnp.zeros((), jnp.int32)),
            operand=None)
        slot = jnp.clip(nl, 0, ec.max_loop_edges - 1)
        li = jnp.where(ok, li.at[slot].set(top_cand[r]), li)
        lj = jnp.where(ok, lj.at[slot].set(top_qslot[r]), lj)
        lT = jnp.where(ok, lT.at[slot].set(T_edge), lT)
        lw = jnp.where(ok, lw.at[slot].set(ec.loop_edge_weight), lw)
        nl = nl + ok.astype(jnp.int32)
        acc_list.append(ok)
        pair_list.append(jnp.where(
            ok, jnp.stack([top_cand[r], top_qslot[r]]),
            jnp.full((2,), -1, jnp.int32)))
        rmse_list.append(v_rmse)
        ncorr_list.append(v_ncorr)

    accepted = jnp.stack(acc_list)
    pairs = jnp.stack(pair_list)
    diag = (top_scores, jnp.stack(rmse_list), jnp.stack(ncorr_list))
    return (li, lj, lT, lw, nl), accepted, pairs, diag


# ---------------------------------------------------------------------------
# pose graph


def _run_pgo(state: EngineState, n_total, ec: EngineConfig):
    """Optimize all keyframe poses with odometry + loop edges."""
    K = ec.max_keyframes
    ei = jnp.arange(K - 1, dtype=jnp.int32)
    ew = (ei + 1 < n_total).astype(jnp.float32)
    pg = posegraph.PoseGraph(
        poses=state.poses,
        edge_i=jnp.concatenate([ei, jnp.clip(state.loop_i, 0, K - 1)]),
        edge_j=jnp.concatenate([ei + 1, jnp.clip(state.loop_j, 0, K - 1)]),
        edge_T=jnp.concatenate([state.rel_T[1:], state.loop_T], axis=0),
        edge_w=jnp.concatenate([ew, state.loop_w]))
    res = posegraph.optimize(pg, gn_iters=ec.pgo_gn_iters,
                             cg_iters=ec.pgo_cg_iters)
    return res.poses, res.final_error


# ---------------------------------------------------------------------------
# map maintenance


def _insert_submaps(state: EngineState, xyz, valid, removed, poses_all,
                    poses_win, slots, is_kf, frame_ids, ec: EngineConfig):
    """Cursor-based insertion of each judged frame's static points into
    its ASSIGNED keyframe's submap (uniform stride subsample, keyframe-
    local frame). A frame that created its keyframe starts at cursor 0
    with the full P budget (identical to the fixed-window behavior);
    non-keyframe frames top up whatever budget their keyframe has left -
    the stride adapts so the top-up still spans the whole scan."""
    Wj = removed.shape[0]
    K, P = state.submap_valid.shape
    N = xyz.shape[1]
    arP = jnp.arange(P, dtype=jnp.int32)

    def one(carry, f):
        fxyz, fval, fidx, ffrm, fill, ovf = carry
        slot = jnp.clip(slots[f], 0, K - 1)
        in_budget = slots[f] < K
        budget = jnp.where(in_budget, P - fill[slot], 0)
        keep = valid[f] & ~removed[f]
        n_keep = jnp.sum(keep.astype(jnp.int32))
        b1 = jnp.maximum(budget, 1)
        stride = jnp.maximum((n_keep + b1 - 1) // b1, 1)
        rank = jnp.cumsum(keep.astype(jnp.int32)) - 1
        sel = keep & (rank % stride == 0)
        # slot p <- the (p+1)-th selected point via binary search on the
        # inclusive selection count (gathers instead of serialized
        # [N]-update scatters; same rewrite as tracking's point budget)
        csel = jnp.cumsum(sel.astype(jnp.int32))
        idx = jnp.searchsorted(csel, jnp.arange(1, P + 1, dtype=csel.dtype),
                               side="left").astype(jnp.int32)
        n_write = jnp.clip(jnp.minimum(csel[-1], budget), 0, P)
        wmask = arP < n_write
        idx_safe = jnp.clip(idx, 0, N - 1)
        pts = xyz[f][idx_safe]
        # keyframe-local coordinates: the frame's own keyframe sees raw
        # sensor points (exactly the fixed-window path); followers warp
        # into the assigned keyframe's frame via current estimates
        T_loc = geometry.matmul(geometry.inverse_se3(poses_all[slot]),
                                poses_win[f])
        warped = geometry.transform_points(T_loc, pts)
        pts = jnp.where(is_kf[f], pts, warped)
        dest = jnp.where(wmask, slot * P + fill[slot] + arP, K * P)
        fxyz = fxyz.at[dest].set(pts, mode='drop')
        fval = fval.at[dest].set(jnp.ones((P,), bool), mode='drop')
        fidx = fidx.at[dest].set(idx_safe, mode='drop')
        ffrm = ffrm.at[dest].set(
            jnp.full((P,), 1, jnp.int32) * frame_ids[f], mode='drop')
        fill = fill.at[slot].add(jnp.where(in_budget, n_write, 0))
        # overflow counts only a keyframe's OWN points past the budget
        # (followers finding a full submap is the expected steady state)
        ovf = ovf + jnp.where(is_kf[f],
                              jnp.maximum(csel[-1] - budget, 0), 0)
        return (fxyz, fval, fidx, ffrm, fill, ovf), None

    init = (state.submap_xyz.reshape(K * P, 3),
            state.submap_valid.reshape(K * P),
            state.submap_idx.reshape(K * P),
            state.submap_frame.reshape(K * P),
            state.submap_fill, jnp.zeros((), jnp.int32))
    (fxyz, fval, fidx, ffrm, fill, ovf), _ = jax.lax.scan(
        one, init, jnp.arange(Wj))
    return (fxyz.reshape(K, P, 3), fval.reshape(K, P),
            fidx.reshape(K, P), ffrm.reshape(K, P), fill, ovf)


def world_map(state: EngineState) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Assemble the current static world map: [K*P,3] points + validity.
    Submaps are keyframe-local, so this always reflects the latest
    pose-graph estimates."""
    K = state.poses.shape[0]
    pts = jnp.einsum('kij,kpj->kpi', state.poses[:, :3, :3],
                     state.submap_xyz, precision="highest") \
        + state.poses[:, None, :3, 3]
    valid = state.submap_valid & (
        jnp.arange(K)[:, None] < jnp.maximum(state.n - 1, 0))
    return pts.reshape(-1, 3), valid.reshape(-1)


def _erasor_pass(state: EngineState, scan_xyz, scan_valid, pose,
                 ec: EngineConfig):
    """Clean the accumulated map against one scan taken at `pose`."""
    map_xyz, map_valid = world_map(state)
    warped = geometry.transform_points(pose, scan_xyz)
    res = erasor_mod.clean_map(map_xyz, map_valid, warped, scan_valid,
                               pose[:3, 3], ec.erasor)
    K, P = state.submap_valid.shape
    new_valid = state.submap_valid & ~res.dynamic.reshape(K, P)
    removed = jnp.sum(res.dynamic).astype(jnp.int32)
    return new_valid, removed


# ---------------------------------------------------------------------------
# the window step


@functools.partial(jax.jit,
                   static_argnames=("first", "run_erasor", "ec", "cfg"))
def process_window(state: EngineState, xyz, intensity, valid,
                   first: bool, run_erasor: bool,
                   ec: EngineConfig, cfg: PipelineConfig
                   ) -> tuple[EngineState, WindowOutput]:
    """One engine step over a window of W scans ([W,N,...], sensor frame).

    For continuing windows, scan 0 must be the previous window's last scan
    (the 1-frame overlap; its keyframe assignment already exists and it
    gets its dynamic verdict here, exactly once).
    """
    W = xyz.shape[0]
    # global scan ids of the window's frames (the overlap scan was
    # already counted)
    frame_ids = state.frames - (0 if first else 1) \
        + jnp.arange(W, dtype=jnp.int32)

    # ---- 1. odometry
    A_T, n_corr, rmse, pose_A, n_fallback = _window_odometry(
        state, xyz, valid, first, ec, cfg)

    # fault injection: compose a constant se(3) bias onto every relative
    # transform (static python branch - zero-cost when the bias is zero)
    if any(b != 0.0 for b in ec.drift_bias):
        bias = geometry.exp_se3(jnp.asarray(ec.drift_bias, xyz.dtype))
        rel = jnp.einsum(
            'wij,wjk->wik',
            geometry.inverse_se3(A_T[:-1]), A_T[1:], precision="highest")
        rel = jnp.einsum('wij,jk->wik', rel, bias, precision="highest")
        A_T = jnp.concatenate([A_T[:1], posegraph.odometry_chain(rel)[1:]],
                              axis=0)

    rel_win = geometry.orthonormalize_se3(jnp.einsum(
        'wij,wjk->wik', geometry.inverse_se3(A_T[:-1]), A_T[1:],
        precision="highest"))
    poses_win = geometry.orthonormalize_se3(
        jnp.einsum('ij,wjk->wik', pose_A, A_T, precision="highest"))

    # ---- 2. keyframe selection + keyframe-table writes (scatter with
    # mode='drop': past-budget keyframes are dropped and counted, never
    # silently overwritten)
    K = ec.max_keyframes
    is_kf, slots, rel_kf, n_end = _keyframe_gate(state, poses_win, first,
                                                 ec)
    widx = jnp.where(is_kf & (slots < K), slots, K)
    poses_new = state.poses.at[widx].set(poses_win, mode='drop')
    rel_new = state.rel_T.at[widx].set(rel_kf, mode='drop')
    kff_new = state.kf_frame.at[widx].set(frame_ids, mode='drop')
    n_drop = jnp.sum(is_kf & (slots >= K)).astype(jnp.int32)
    state = state.replace(
        poses=poses_new, rel_T=rel_new, kf_frame=kff_new,
        n=jnp.minimum(n_end, K),
        frames=state.frames + (W if first else W - 1),
        last_pose=poses_win[-1], last_rel=rel_win[-1],
        kf_overflow=state.kf_overflow + n_drop,
        odo_fallbacks=state.odo_fallbacks + n_fallback)

    # descriptors: computed ONCE per window frame, reused for both the
    # keyframe bank and the loop queries below
    def mkdesc(f):
        return scan_context.descriptor(xyz[f], valid[f], ec.desc)
    descs = jax.lax.map(mkdesc, jnp.arange(W))
    state = state.replace(desc=state.desc.at[widx].set(descs, mode='drop'))

    # ---- 3. segmentation + tracking (streaming carry)
    init_track = None if first else (state.track_table, state.track_grid,
                                     state.track_counter)
    res = pipeline.run_window(xyz, intensity, valid, poses_win, cfg,
                              init_track=init_track)
    # boundary carry for the next window: the LAST frame's mutated state
    last_table = jax.tree.map(lambda a: a[-1], res.tables)
    state = state.replace(
        track_table=last_table, track_grid=res.label_grids[-1],
        track_counter=res.track_counter,
        row_overflow=state.row_overflow + res.new_row_overflow,
        point_overflow=state.point_overflow + res.track_point_overflow)

    # ---- 4. submaps for judged frames (all but the window's last)
    sub_xyz, sub_val, sub_idx, sub_frm, fill, ovf = _insert_submaps(
        state, xyz[:-1], valid[:-1], res.removed[:-1], state.poses,
        poses_win[:-1], slots[:-1], is_kf[:-1], frame_ids[:-1], ec)
    state = state.replace(submap_xyz=sub_xyz, submap_valid=sub_val,
                          submap_idx=sub_idx, submap_frame=sub_frm,
                          submap_fill=fill,
                          submap_overflow=state.submap_overflow + ovf)

    # ---- 5. loop closure (top-k distinct candidates)
    (li, lj, lT, lw, nl), accepted, pairs, loop_diag = _window_loops(
        state, xyz, valid, descs, slots, is_kf, first, ec, cfg)
    state = state.replace(loop_i=li, loop_j=lj, loop_T=lT, loop_w=lw,
                          n_loops=nl)

    # ---- 6. pose graph (only when a loop landed this window)
    def do_pgo(s):
        poses, err = _run_pgo(s, s.n, ec)
        return s.replace(poses=poses), err

    state, pgo_err = jax.lax.cond(
        jnp.any(accepted), do_pgo, lambda s: (s, jnp.zeros(())), state)

    # ---- 7. periodic map cleaning
    if run_erasor:
        new_valid, removed_cnt = _erasor_pass(
            state, xyz[-1], valid[-1], state.last_pose, ec)
        state = state.replace(
            submap_valid=new_valid,
            erasor_removed=state.erasor_removed + removed_cnt)

    out = WindowOutput(removed=res.removed[:-1], poses=poses_win,
                       n_dynamic=res.n_dynamic,
                       odo_n_corr=n_corr, odo_rmse=rmse,
                       is_kf=is_kf, kf_slot=slots,
                       loop_accepted=accepted, loop_pair=pairs,
                       loop_score=loop_diag[0], loop_rmse=loop_diag[1],
                       loop_ncorr=loop_diag[2],
                       pgo_error=pgo_err)
    return state, out


def finalize(state: EngineState, ec: EngineConfig,
             cfg: PipelineConfig) -> EngineState:
    """End-of-sequence: one final pose-graph solve (if any loops) plus a
    final ERASOR sweep against the most recent keyframe's scan footprint
    is the host driver's job (it still owns that scan); here we re-run
    PGO so the returned poses reflect every accepted edge."""
    def do(s):
        poses, _ = _run_pgo(s, s.n, ec)
        return s.replace(poses=poses)
    return jax.lax.cond(state.n_loops > 0, do, lambda s: s, state)


# ---------------------------------------------------------------------------
# host driver


class SlamEngine:
    """Host-side streaming driver: feed scans, get a map + trajectory.

    Owns the EngineState, the window re-batching (1-frame overlap), the
    checkpoint cadence, and numpy-land diagnostics. All compute happens in
    the jitted `process_window`.
    """

    def __init__(self, cfg: PipelineConfig, ec: EngineConfig | None = None,
                 ckpt_dir: str | None = None, ckpt_every: int = 0,
                 materialize_outputs: bool = True):
        self.cfg = cfg
        self.ec = ec or EngineConfig()
        self.state = init_state(self.ec, cfg)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        # materialize_outputs=False keeps WindowOutputs device-resident
        # (each per-leaf host fetch is a blocking round trip; a
        # downstream consumer that lives on device - or a caller that
        # batches its fetches - should opt out). It also defers the
        # keyframe-budget check to finalize() (one scalar fetch per
        # window otherwise).
        self.materialize_outputs = materialize_outputs
        self._pending: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._first = True
        self._overlap = None
        self._frames = 0
        self._last_ckpt = 0
        self.windows = 0
        self.outputs: list[WindowOutput] = []

    @property
    def n_frames(self) -> int:
        """Scans processed so far (host-side counter)."""
        return self._frames

    @property
    def n_keyframes(self) -> int:
        return int(self.state.n)

    def feed(self, xyz: np.ndarray, intensity: np.ndarray,
             valid: np.ndarray) -> WindowOutput | None:
        """Queue one scan; runs a window step when enough scans buffered.
        Returns the WindowOutput when a step ran, else None."""
        self._pending.append((xyz, intensity, valid))
        need = self.ec.window if self._first else self.ec.window - 1
        if len(self._pending) < need:
            return None
        return self._run_window()

    def flush(self) -> WindowOutput | None:
        """Process whatever scans remain (shorter final window)."""
        need_min = 2 if self._first else 1
        if len(self._pending) < need_min:
            if self._pending:
                import warnings
                warnings.warn(
                    f"flush(): {len(self._pending)} pending scan(s) cannot "
                    f"form a minimal window (need {need_min}) and will not "
                    "be processed; feed at least 2 scans total",
                    stacklevel=2)
            return None
        return self._run_window()

    def _check_budget(self) -> None:
        ovf = int(self.state.kf_overflow)
        if ovf > 0:
            raise ValueError(
                f"keyframe budget exhausted: {ovf} keyframe(s) past "
                f"max_keyframes={self.ec.max_keyframes} were dropped "
                "(their poses/submaps are NOT in the state). Enable "
                "keyframe gating (EngineConfig.kf_dist / kf_rot) so K "
                "covers the trajectory, or raise max_keyframes")

    def _run_window(self) -> WindowOutput:
        batch = self._pending
        self._pending = []
        if not self._first:
            batch = [self._overlap] + batch
        # jnp.stack keeps device-resident scans on device (feeding numpy
        # arrays works too, at the cost of one host->device transfer per
        # window)
        xyz = jnp.stack([jnp.asarray(b[0]) for b in batch])
        inten = jnp.stack([jnp.asarray(b[1]) for b in batch])
        valid = jnp.stack([jnp.asarray(b[2]) for b in batch])

        self.windows += 1
        run_er = (self.ec.erasor_every > 0
                  and self.windows % self.ec.erasor_every == 0)
        self.state, out = process_window(
            self.state, xyz, inten, valid, self._first, run_er,
            self.ec, self.cfg)
        self._frames += len(batch) if self._first else len(batch) - 1
        self._overlap = batch[-1]
        self._first = False
        self.outputs.append(jax.tree.map(np.asarray, out)
                            if self.materialize_outputs else out)
        if self.materialize_outputs:
            # keyframe-budget backstop: in-graph writes past K are
            # dropped (never corrupting), the host surfaces them loudly
            self._check_budget()

        if (self.ckpt_dir and self.ckpt_every
                and self._frames - self._last_ckpt >= self.ckpt_every):
            self.checkpoint()
            self._last_ckpt = self._frames
        return self.outputs[-1]

    def finalize(self, final_erasor: bool = True) -> None:
        """Final PGO + optional last ERASOR sweep using the overlap scan."""
        if len(self._pending):
            self.flush()
        self._check_budget()
        self.state = finalize(self.state, self.ec, self.cfg)
        if final_erasor and self._overlap is not None:
            xyz, _, valid = self._overlap
            pose = self.state.last_pose
            new_valid, removed = jax.jit(
                _erasor_pass, static_argnames=("ec",))(
                self.state, jnp.asarray(xyz), jnp.asarray(valid), pose,
                self.ec)
            self.state = self.state.replace(
                submap_valid=new_valid,
                erasor_removed=self.state.erasor_removed + removed)

    # -- results ----------------------------------------------------------

    def poses(self) -> np.ndarray:
        """[n_keyframes,4,4] optimized keyframe poses."""
        return np.asarray(self.state.poses[:self.n_keyframes])

    def kf_frames(self) -> np.ndarray:
        """[n_keyframes] scan id of each keyframe (for GT alignment)."""
        return np.asarray(self.state.kf_frame[:self.n_keyframes])

    def static_map(self) -> np.ndarray:
        pts, valid = world_map(self.state)
        return np.asarray(pts)[np.asarray(valid)]

    # -- checkpoint / resume ----------------------------------------------

    def _config_fingerprint(self) -> str:
        """Deterministic digest of every config field that shapes the
        EngineState pytree - persisted with checkpoints and validated at
        resume so mismatched max_keyframes/submap_points/window/grid caps
        fail loudly instead of silently corrupting restored state."""
        import hashlib
        payload = repr((self.ec, self.cfg)).encode()
        return hashlib.sha256(payload).hexdigest()

    def checkpoint(self, path: str | None = None) -> str:
        from pathlib import Path
        from ..utils import checkpoint as ckpt
        if self._overlap is None:
            raise RuntimeError(
                "checkpoint() before any window has run: nothing to save "
                "(feed at least one full window first)")
        path = path or str(Path(self.ckpt_dir or ".")
                           / f"engine_{self._frames:06d}")
        leaves = jax.tree.leaves(self.state)
        ov_x, ov_i, ov_v = self._overlap
        ckpt.save(path, {
            "leaves": {f"{i:04d}": leaf for i, leaf in enumerate(leaves)},
            "overlap_xyz": ov_x, "overlap_int": ov_i, "overlap_val": ov_v,
            "windows": np.asarray(self.windows),
            "frames": np.asarray(self._frames),
            "config_sha": np.frombuffer(
                self._config_fingerprint().encode(), dtype=np.uint8),
        })
        return path

    @classmethod
    def resume(cls, path: str, cfg: PipelineConfig,
               ec: EngineConfig | None = None,
               ckpt_dir: str | None = None,
               ckpt_every: int = 0) -> "SlamEngine":
        from ..utils import checkpoint as ckpt
        eng = cls(cfg, ec, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)
        data = ckpt.load(path)
        if "config_sha" in data:
            saved = bytes(np.asarray(data["config_sha"])).decode()
            now = eng._config_fingerprint()
            if saved != now:
                raise ValueError(
                    "checkpoint/config mismatch: the checkpoint was written "
                    "with a different EngineConfig/PipelineConfig "
                    f"(saved {saved[:12]}..., current {now[:12]}...); "
                    "resume with the original configs")
        template = jax.tree.structure(eng.state)
        tmpl_leaves = jax.tree.leaves(eng.state)
        leaves = [jnp.asarray(data["leaves"][k])
                  for k in sorted(data["leaves"])]
        if len(leaves) != len(tmpl_leaves):
            raise ValueError(
                f"checkpoint has {len(leaves)} leaves, expected "
                f"{len(tmpl_leaves)} - incompatible checkpoint")
        for i, (got, want) in enumerate(zip(leaves, tmpl_leaves)):
            if got.shape != want.shape:
                raise ValueError(
                    f"checkpoint leaf {i} has shape {got.shape}, expected "
                    f"{want.shape} - was the checkpoint written with "
                    "different max_keyframes/submap_points/shape caps?")
        eng.state = jax.tree.unflatten(template, leaves)
        eng._overlap = (data["overlap_xyz"], data["overlap_int"],
                        data["overlap_val"])
        eng._first = False
        eng.windows = int(data["windows"])
        eng._frames = int(data["frames"])
        eng._last_ckpt = eng._frames
        return eng
