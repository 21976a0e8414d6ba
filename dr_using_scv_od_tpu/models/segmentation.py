"""Curved-voxel segmentation engine: CVC clustering, intensity-based cluster
refinement ("RI3"), bounding-box filtering.

Accelerator re-design of `SSC::segment` (src/ssc.cpp:637-656):
  * CVC clustering (src/ssc.cpp:299-419) -> connected components over the
    occupied-voxel grid (ops/clustering.py);
  * refineClusterByIntensity (src/ssc.cpp:571-635) -> predicate-gated label
    propagation over a radius-`search_c` Chebyshev neighbourhood, followed
    by cluster-wide min-label broadcast (replaces the order-dependent
    sequential fuse with a deterministic min-id merge; SURVEY.md 7.3);
  * refineClusterByBoundingBox (src/ssc.cpp:437-467) -> masked segment
    reductions + cluster-table row invalidation.

The neighbourhood radius shrinks to 1 beyond `far_range_frac * range_num`
range bins exactly like findVoxelNeighbors (src/ssc.cpp:397-399).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..types import ClusterTable, VoxelGrid
from ..ops import clustering, segment_ops

# point_route codes for evaluation accounting
ROUTE_PIPELINE = 0      # survives in a live cluster
ROUTE_GROUND = 1        # removed as ground (treated static downstream)
ROUTE_OUT_OF_FOV = 2    # outside curved grid (treated static, ssc.cpp:161-172)
ROUTE_DROPPED = 3       # patchwork drop (neither ground nor nonground)
ROUTE_BBOX_STATIC = 4   # cluster erased by bbox filter, routed static
ROUTE_BBOX_DYNAMIC = 5  # cluster erased by bbox filter, routed dynamic


class SegmentResult(NamedTuple):
    root_grid: jnp.ndarray      # [G] int32 per-voxel root label after refine
    label_grid: jnp.ndarray     # [G] int32 compact cluster id, -1 empty
    point_cluster: jnp.ndarray  # [N] int32 compact cluster id, -1 none
    clusters: ClusterTable
    point_route: jnp.ndarray    # [N] int32 ROUTE_*
    n_clusters: jnp.ndarray     # scalar int32
    overflow_points: jnp.ndarray  # scalar int32 (cluster-cap overflow)
    planar_vox: jnp.ndarray     # [G] bool per-voxel planarity (from the
    #                             fused moment scatter; feeds recognition's
    #                             RPC replacement with no extra scatter)
    n_planar: jnp.ndarray       # [C] f32 planar-point count per cluster
    #                             (rides the segment histogram matmul)


def _shift_gather(padded: jnp.ndarray, da: jnp.ndarray, dr: jnp.ndarray,
                  ds: jnp.ndarray, shape3, pad: int) -> jnp.ndarray:
    """Slice a padded 3-D array at offset (da, dr, ds) in [-pad, pad]."""
    A, R, S = shape3
    return jax.lax.dynamic_slice(
        padded, (da + pad, dr + pad, ds + pad), (A, R, S))


def refine_by_intensity(root_grid: jnp.ndarray, grid: VoxelGrid,
                        cfg: PipelineConfig) -> jnp.ndarray:
    """RI3: fuse clusters through intensity-homogeneous neighbour voxels.

    For each occupied voxel v and neighbour n with Chebyshev distance <=
    r(v) (search_c, or 1 at far range): if n is occupied, var(n) <=
    intensity_cov and |mean(v) - mean(n)| <= intensity_diff, the clusters of
    v and n merge (reference predicate at src/ssc.cpp:588-595). Merging is
    min-root-label union followed by a cluster-wide broadcast so the merge
    is transitive within an iteration.

    The predicate is asymmetric (variance is checked on the NEIGHBOUR only)
    but the reference's fusion is an undirected union - cluster c fuses
    with every label in its qualifying neighbour set regardless of label
    order (src/ssc.cpp:605-626). A min-pull alone would union only when the
    qualifying direction points at the smaller label, so each offset is
    evaluated BOTH ways: v pulls lab(n) when edge (v->n) qualifies, and v
    also pulls lab(n) when the reverse-centred edge (n->v) qualifies
    (cov(v) <= thr, radius taken at n) - together an undirected union of
    every qualifying edge (verified against the sequential oracle in
    tests/test_oracle_reference.py).
    """
    shape3 = cfg.grid.shape
    A, R, S = shape3
    g = cfg.grid.bin_num
    sentinel = g
    pad = cfg.seg.search_c

    occ3 = grid.occupied.reshape(shape3)
    av3 = grid.intensity_mean.reshape(shape3)
    cov3 = grid.intensity_var.reshape(shape3)

    occ_p = jnp.pad(occ3, pad, constant_values=False)
    av_p = jnp.pad(av3, pad, constant_values=jnp.inf)
    cov_p = jnp.pad(cov3, pad, constant_values=jnp.inf)

    # per-voxel neighbourhood radius (src/ssc.cpp:397-399)
    r_idx = jax.lax.broadcasted_iota(jnp.int32, shape3, 1)
    radius = jnp.where(r_idx > int(cfg.grid.range_num * cfg.seg.far_range_frac),
                       1, cfg.seg.search_c)

    side = 2 * pad + 1
    # neighbour quality is a per-voxel property (occupied & low variance);
    # precompute it once - only the |mean difference| term is pairwise
    ok_vox_p = occ_p & (cov_p <= cfg.seg.intensity_cov)
    self_ok = occ3 & (cov3 <= cfg.seg.intensity_cov)

    def one_iteration(lab: jnp.ndarray) -> jnp.ndarray:
        lab3 = lab.reshape(shape3)
        lab_p = jnp.pad(lab3, pad, constant_values=sentinel)

        # static unroll of the (da, dr) plane (25 shifts of elementwise
        # work) inside a short fori over ds (a choice made for the
        # previous accelerator, queued for measurement on the H100)
        def ds_body(k, m):
            ds = k - pad
            for da in range(-pad, pad + 1):
                for dr in range(-pad, pad + 1):
                    cheb = max(abs(da), abs(dr))
                    cheb_full = jnp.maximum(cheb, jnp.abs(ds))
                    nb_lab = _shift_gather(lab_p, da, dr, ds, shape3, pad)
                    nb_ok = _shift_gather(ok_vox_p, da, dr, ds, shape3, pad)
                    nb_occ = _shift_gather(occ_p, da, dr, ds, shape3, pad)
                    nb_av = _shift_gather(av_p, da, dr, ds, shape3, pad)
                    close = jnp.abs(av3 - nb_av) <= cfg.seg.intensity_diff
                    # pull: edge centred at v (neighbour variance + r(v))
                    ok = nb_ok & (cheb_full <= radius) & close
                    # push folded into the opposite offset: edge centred at
                    # n = v + d qualifies with cov(v) and radius(r_idx+dr);
                    # radius is analytic in the range index, so the shifted
                    # radius costs no gather
                    radius_n = jnp.where(
                        r_idx + dr > int(cfg.grid.range_num
                                         * cfg.seg.far_range_frac),
                        1, cfg.seg.search_c)
                    ok = ok | (nb_occ & self_ok & (cheb_full <= radius_n)
                               & close)
                    m = jnp.minimum(m, jnp.where(ok, nb_lab, sentinel))
            return m

        m = jax.lax.fori_loop(0, side, ds_body,
                              jnp.full(shape3, sentinel, lab.dtype))
        new = jnp.where(occ3, jnp.minimum(lab3, m), lab3).reshape(-1)
        # broadcast the min label cluster-wide (transitive closure of this
        # round's merges, two sweeps suffice for min-propagation chains)
        for _ in range(2):
            cluster_min = jax.ops.segment_min(
                new, jnp.where(occ3.reshape(-1), lab, sentinel),
                num_segments=sentinel + 1)
            upd = cluster_min[jnp.clip(lab, 0, sentinel)]
            new = jnp.where(occ3.reshape(-1), jnp.minimum(new, upd), new)
            # re-key: labels themselves moved; fold through the new labels
            lab = new
        return new

    lab = root_grid
    for _ in range(cfg.seg.iteration):
        lab = one_iteration(lab)
    return lab


def segment_frame(xyz: jnp.ndarray, intensity: jnp.ndarray,
                  nonground: jnp.ndarray, ground: jnp.ndarray,
                  dropped: jnp.ndarray, cfg: PipelineConfig
                  ) -> Tuple[SegmentResult, jnp.ndarray, VoxelGrid]:
    """Segment one frame's non-ground cloud.

    Returns (SegmentResult, point_voxel [N] int32, VoxelGrid).
    Mirrors process()+segment() (src/ssc.cpp:224-251, 637-656) minus ground
    extraction, which the caller runs (models/patchwork.py).
    """
    from ..ops import quantize  # local import to avoid cycle
    from . import recognition

    g = cfg.grid.bin_num
    sentinel = g
    shape3 = cfg.grid.shape

    idx3, flat, in_fov = quantize.quantize(xyz, nonground, cfg.grid)
    # one wide scatter: intensity stats + xyz moments (planarity feeds
    # recognition's RPC replacement without a second scatter pass)
    grid, moments = quantize.voxel_stats_moments(flat, xyz, intensity,
                                                 in_fov, cfg.grid)
    planar_vox = recognition.voxel_planarity_from_moments(
        grid.count, moments, cfg)

    # --- CVC connected components + RI3 intensity refinement.
    # cfg.seg.iteration bounds the refine rounds exactly like the
    # reference's loop (src/ssc.cpp:1143); iteration == 0 disables RI3
    # (the "-RI3" ablation).
    occ3 = grid.occupied.reshape(shape3)
    root_grid = clustering.connected_components(occ3, cfg.seg.cc_max_iters)
    if cfg.seg.iteration > 0:
        root_grid = refine_by_intensity(root_grid, grid, cfg)

    # --- compact to cluster table (sort-free, off the grid)
    roots, point_cluster, label_grid, n_clusters, overflow = \
        clustering.compact_grid_labels(
            root_grid, grid.occupied, flat, in_fov,
            cfg.shapes.max_clusters, sentinel)

    C = cfg.shapes.max_clusters
    # per-cluster point counts = voxel-count-weighted grid histogram (a
    # matmul): exactly the per-point segment count, because every in-FOV
    # point's voxel carries its cluster label and grid.count counts
    # exactly the in-FOV points per voxel - but with no [N]-update
    # scatter. Voxel counts AND recognition's
    # planar-point counts ride the same one-hot formation; n_planar over
    # the PRE-filter grid is exact for every live cluster (dropped rows'
    # voxels differ but their planar_ratio is never consumed).
    cnt_f = grid.count.astype(jnp.float32)
    n_voxels, (n_points_f, n_planar) = segment_ops.grid_label_hist_multi(
        label_grid, C, [cnt_f, jnp.where(planar_vox, cnt_f, 0.0)],
        weight_bound=cfg.shapes.max_points + 1)
    n_points = n_points_f.astype(jnp.int32)
    # scatter-free chunked broadcast-compare min/max, bit-identical to the
    # wide scatter (tests/test_clustering.py::
    # test_segment_minmax_bcast_matches_scatter); a choice made for the
    # previous accelerator, queued for measurement on the H100
    bbox_min, bbox_max = segment_ops.segment_minmax_bcast(
        xyz, point_cluster, in_fov, C)
    grid_valid = label_grid >= 0
    alive = roots != sentinel

    # --- bounding-box refinement (src/ssc.cpp:437-467)
    dz = bbox_max[:, 2] - bbox_min[:, 2]
    drop = alive & ((bbox_min[:, 2] > 0.0)
                    | (n_points < cfg.seg.to_be_class)
                    | (dz < cfg.seg.min_cluster_z_extent))
    # eval routing of dropped clusters (the reference's intent at
    # src/ssc.cpp:449-453; its missing `else` double-appends to static -
    # we implement the intended split and keep both sets out of the
    # dynamic verdict, which reproduces the effective metric behaviour)
    drop_dynamic = drop & ((bbox_min[:, 2] < cfg.seg.refine_height)
                           | (n_points < cfg.seg.to_be_class))
    alive = alive & ~drop

    # erase dropped clusters from the grid + points. All three per-
    # element reads of the [C]-row verdict tables run as select trees
    # (segment_ops.small_table_lookup) instead of gathers (a choice made
    # for the previous accelerator, queued for measurement on the H100).
    keep_row = alive
    keep_g = segment_ops.small_table_lookup(
        keep_row, jnp.clip(label_grid, 0, C - 1), 1)
    label_grid = jnp.where(grid_valid & keep_g, label_grid, -1)
    pc_safe = jnp.clip(point_cluster, 0, C - 1)
    point_alive = (point_cluster >= 0) & segment_ops.small_table_lookup(
        keep_row, pc_safe, 1)
    point_in_dropped = (point_cluster >= 0) & ~point_alive
    dd_pt = segment_ops.small_table_lookup(drop_dynamic, pc_safe, 1)

    route = jnp.full(xyz.shape[0], ROUTE_OUT_OF_FOV, jnp.int32)
    route = jnp.where(ground, ROUTE_GROUND, route)
    route = jnp.where(dropped, ROUTE_DROPPED, route)
    route = jnp.where(in_fov, ROUTE_PIPELINE, route)
    route = jnp.where(point_in_dropped & dd_pt,
                      ROUTE_BBOX_DYNAMIC, route)
    route = jnp.where(point_in_dropped & ~dd_pt,
                      ROUTE_BBOX_STATIC, route)
    point_cluster = jnp.where(point_alive, point_cluster, -1)

    table = ClusterTable(
        valid=alive,
        n_points=n_points,
        n_voxels=n_voxels,
        bbox_min=jnp.where(alive[:, None], bbox_min, 0.0),
        bbox_max=jnp.where(alive[:, None], bbox_max, 0.0),
        type=jnp.full((C,), -1, jnp.int32),
        state=jnp.full((C,), -1, jnp.int32),
        track_id=jnp.full((C,), -1, jnp.int32),
    )
    result = SegmentResult(
        root_grid=root_grid,
        label_grid=label_grid,
        point_cluster=point_cluster,
        clusters=table,
        point_route=route,
        n_clusters=jnp.sum(alive).astype(jnp.int32),
        overflow_points=overflow,
        planar_vox=planar_vox,
        n_planar=n_planar,
    )
    return result, flat, grid
