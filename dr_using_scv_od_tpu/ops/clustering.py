"""Connected-component labeling on the curved-voxel grid.

Vectorized replacement of the reference's CVC clustering
(`SSC::clusterAndCreateFrame` + `mergeClusters`, src/ssc.cpp:299-419).
The reference unions points through 3x3x3 voxel neighbourhoods with an
eager O(N) full-rescan merge; the fixpoint it reaches is exactly the
connected components of *occupied voxels* under 26-connectivity (any two
occupied voxels within Chebyshev distance 1 share a cluster, transitively).

Here that fixpoint is computed directly by iterative min-label propagation:
  * neighbourhood min via three separable 3-tap min-pools (azimuth, range,
    sector) - a full 26-neighbourhood min per iteration;
  * pointer jumping (label <- label[label]) for O(log diameter) convergence;
  * a `lax.while_loop` with a change flag bounds the iteration count.

Note the grid does NOT wrap in the sector dimension - neither does the
reference (findVoxelNeighbors clamps at sector 0 / sector_num-1,
src/ssc.cpp:402-403), so a cluster spanning the 0/360-degree seam splits
there in both implementations.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _neighbor_min(lab3: jnp.ndarray, occ3: jnp.ndarray,
                  sentinel: int) -> jnp.ndarray:
    """Min label over each cell's 3x3x3 neighbourhood (separable passes);
    unoccupied cells contribute `sentinel`."""
    m = jnp.where(occ3, lab3, sentinel)
    for axis in range(3):
        lo = jnp.concatenate(
            [jnp.full_like(jnp.take(m, jnp.array([0]), axis=axis), sentinel),
             jax.lax.slice_in_dim(m, 0, m.shape[axis] - 1, axis=axis)],
            axis=axis)
        hi = jnp.concatenate(
            [jax.lax.slice_in_dim(m, 1, m.shape[axis], axis=axis),
             jnp.full_like(jnp.take(m, jnp.array([0]), axis=axis), sentinel)],
            axis=axis)
        m = jnp.minimum(m, jnp.minimum(lo, hi))
    return m


def _segmented_min_scan(lab3: jnp.ndarray, occ3: jnp.ndarray,
                        sentinel: int, axis: int) -> jnp.ndarray:
    """Min-label propagation along whole occupied RUNS of one axis in a
    single (log-depth) pass: a segmented min-scan forward + backward,
    where empty voxels break segments. One call spreads a label across an
    entire wall/run instead of one voxel per iteration."""
    v = jnp.where(occ3, lab3, sentinel)
    flag = ~occ3  # empty cells start a new segment

    def combine(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, jnp.minimum(av, bv)), af | bf

    fwd, _ = jax.lax.associative_scan(combine, (v, flag), axis=axis)
    bwd, _ = jax.lax.associative_scan(combine, (v, flag), axis=axis,
                                      reverse=True)
    out = jnp.minimum(fwd, bwd)
    return jnp.where(occ3, out, lab3)


def connected_components(occupied: jnp.ndarray, max_iters: int = 64
                         ) -> jnp.ndarray:
    """Label occupied voxels by connected component (26-connectivity).

    Args:
      occupied: [A, R, S] bool.
      max_iters: hard iteration cap (defensive bound, SURVEY.md 7.3: with
        run-scans + pointer jumping components converge in a handful of
        iterations; labels strictly decrease so convergence is provable,
        but the cap guarantees termination even if that argument rots).

    Returns:
      [G] int32 flat label array; each occupied voxel holds the minimum flat
      voxel id of its component, each empty voxel holds its own flat id
      (a harmless self-loop that keeps gathers in bounds).
    """
    shape3 = occupied.shape
    g = occupied.size
    sentinel = g  # larger than any real label
    occ = occupied.reshape(-1)
    own = jnp.arange(g, dtype=jnp.int32)
    lab = own

    # Each iteration: (a) segmented min-scans spread labels across whole
    # occupied runs of the sector and range axes (log-depth, shift-only);
    # (b) a 3x3x3 separable neighbour min hops across diagonal/azimuth
    # connections; (c) a periodic pointer-jump (gathers, amortized over
    # two iterations - a cadence chosen for the previous accelerator,
    # queued for measurement on the H100) collapses remaining label
    # chains.
    JUMP_EVERY = 2

    def body(state):
        lab, _, it = state
        lab3 = lab.reshape(shape3)
        lab3 = _segmented_min_scan(lab3, occupied, sentinel, axis=2)
        lab3 = _segmented_min_scan(lab3, occupied, sentinel, axis=1)
        m = _neighbor_min(lab3, occupied, sentinel).reshape(-1)
        new = jnp.where(occ, jnp.minimum(lab3.reshape(-1), m), lab)

        def jump(x):
            x = jnp.where(occ, jnp.minimum(x, x[x]), x)
            return jnp.where(occ, jnp.minimum(x, x[x]), x)

        new = jax.lax.cond(it % JUMP_EVERY == JUMP_EVERY - 1, jump,
                           lambda x: x, new)
        changed = jnp.any(new != lab)
        return new, changed, it + 1

    lab, _, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < max_iters), body,
        (lab, jnp.array(True), jnp.zeros((), jnp.int32)))
    return lab


def _cumsum_matmul(bits: jnp.ndarray, block: int = 1024) -> jnp.ndarray:
    """Inclusive cumsum of a 0/1 int vector as ONE matmul.

    Reshapes to [G/B, B] rows and multiplies by an upper-triangular ones
    matrix instead of XLA's log-depth cumsum scan (a choice made for the
    previous accelerator; against `jnp.cumsum` on the H100 it is queued
    for measurement). Exact: 0/1
    entries are bf16-exact and every partial sum (< 2^24) accumulates in
    f32."""
    n = bits.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    rows = jnp.pad(bits.astype(jnp.bfloat16), (0, pad)).reshape(nb, block)
    tri = (jnp.arange(block)[:, None] <= jnp.arange(block)[None, :]
           ).astype(jnp.bfloat16)
    within = jnp.matmul(rows, tri, preferred_element_type=jnp.float32)
    row_tot = within[:, -1]
    offs = jnp.cumsum(row_tot) - row_tot
    return (within + offs[:, None]).reshape(-1)[:n].astype(bits.dtype)


def compact_grid_labels(root_grid: jnp.ndarray, occupied: jnp.ndarray,
                        flat_voxel: jnp.ndarray, in_fov: jnp.ndarray,
                        max_clusters: int, sentinel: int):
    """Sort-free cluster compaction straight off the voxel grid.

    Replaces `compact_labels` + `labels_to_grid` on the hot path: those
    cost a 131k-element sort/unique plus log-depth searchsorted gathers;
    this formulation is one cumsum, one searchsorted over the C roots and
    one [N] gather.

    Root voxels (root_grid[g] == g, occupied) are numbered by an exclusive
    prefix count in ascending flat-id order - the SAME compact-id order the
    sorted-unique produced, so results are bit-identical when the cluster
    count fits `max_clusters` (and both keep the smallest-id clusters when
    it does not). Every occupied voxel holds >= 1 in-FOV point
    (ops/quantize.voxel_stats), so grid components == point components.

    Returns (roots [C] int32 padded with `sentinel`,
             point_cluster [N] int32 (-1 invalid/overflowed),
             label_grid [G] int32 (-1 empty/overflowed),
             n_clusters scalar int32,
             n_dropped_points scalar int32).
    """
    C = max_clusters
    G = root_grid.shape[0]
    occ = occupied
    g_iota = jnp.arange(G, dtype=jnp.int32)
    is_root = occ & (root_grid == g_iota)
    cum = _cumsum_matmul(is_root.astype(jnp.int32))       # [G] roots <= g
    n_roots = cum[-1]
    n_clusters = jnp.minimum(n_roots, C).astype(jnp.int32)

    # roots table WITHOUT a [G] scatter: root c sits at the first g whose
    # inclusive root-count reaches c+1 (cum is sorted, one searchsorted)
    roots = jnp.searchsorted(
        cum, jnp.arange(1, C + 1, dtype=cum.dtype), side="left"
    ).astype(jnp.int32)
    roots = jnp.where(jnp.arange(C) < n_roots, roots, sentinel)

    # compact id per voxel WITHOUT a [G] gather: rank of root_grid in the
    # sorted 512-entry roots table - 'compare_all' runs as C fused [G]
    # compare+add passes instead of a [G] random gather (a choice made for
    # the previous accelerator, queued for measurement on the H100), and
    # overflowed clusters fall out naturally as misses
    pos = jnp.searchsorted(roots, root_grid, side="left",
                           method="compare_all")
    # occupied cells hold genuine root ids, so membership needs no table
    # gather: rank(r) < C  <=>  insertion position < n_clusters (roots
    # are the C smallest root ids, sentinel-padded above)
    hit = occ & (pos < n_clusters)
    label_grid = jnp.where(hit, jnp.clip(pos, 0, C - 1), -1
                           ).astype(jnp.int32)

    safe_flat = jnp.clip(flat_voxel, 0, G - 1)
    point_cluster = jnp.where(in_fov, label_grid[safe_flat], -1)
    n_dropped = jnp.sum(in_fov & (point_cluster < 0))
    return (roots, point_cluster.astype(jnp.int32), label_grid,
            n_clusters, n_dropped.astype(jnp.int32))


def compact_labels(point_roots: jnp.ndarray, point_valid: jnp.ndarray,
                   max_clusters: int, sentinel: int
                   ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Map per-point root labels to compact cluster ids [0, C).

    Replaces the reference's cluster-name bookkeeping (cluster_name counter +
    unordered_map keys, src/ssc.cpp:300-384) with a sorted-unique compaction.

    Returns (roots [max_clusters] int32 padded with `sentinel`,
             point_cluster [N] int32 with -1 for invalid points,
             n_clusters scalar int32,
             n_dropped_points scalar int32 - valid points whose cluster fell
             beyond the cap; nonzero means max_clusters must be raised).
    """
    keys = jnp.where(point_valid, point_roots, sentinel)
    uniq = jnp.unique(keys, size=max_clusters + 1, fill_value=sentinel)
    roots = uniq[:max_clusters]
    n_clusters = jnp.sum(roots != sentinel)
    pos = jnp.searchsorted(roots, keys)
    pos = jnp.clip(pos, 0, max_clusters - 1)
    hit = (roots[pos] == keys) & point_valid
    point_cluster = jnp.where(hit, pos, -1).astype(jnp.int32)
    n_dropped_points = jnp.sum(point_valid & ~hit)
    return roots, point_cluster, n_clusters.astype(jnp.int32), \
        n_dropped_points.astype(jnp.int32)


def labels_to_grid(roots: jnp.ndarray, root_grid: jnp.ndarray,
                   occ: jnp.ndarray, sentinel: int) -> jnp.ndarray:
    """Dense [G] compact-cluster-id grid from per-voxel root labels.

    Replaces the scatter `hash_cloud[v].label = c.first`
    (src/ssc.cpp:387-391). Empty / dropped voxels get -1.
    """
    keys = jnp.where(occ, root_grid, sentinel)
    pos = jnp.clip(jnp.searchsorted(roots, keys), 0, roots.shape[0] - 1)
    hit = (roots[pos] == keys) & occ
    return jnp.where(hit, pos, -1).astype(jnp.int32)
