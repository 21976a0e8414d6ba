"""Connected-components label propagation vs a scipy/python reference
(union-find over 26-neighbourhoods, the fixpoint of src/ssc.cpp:299-419)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dr_using_scv_od_tpu.ops import clustering


def brute_cc(occ):
    """Union-find CC with 26-connectivity over an [A,R,S] bool grid."""
    A, R, S = occ.shape
    parent = {}

    def find(v):
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    idx = np.argwhere(occ)
    for a, r, s in idx:
        parent[(a, r, s)] = parent.get((a, r, s), (a, r, s))
    for a, r, s in idx:
        for da in (-1, 0, 1):
            for dr in (-1, 0, 1):
                for ds in (-1, 0, 1):
                    na, nr, ns = a + da, r + dr, s + ds
                    if 0 <= na < A and 0 <= nr < R and 0 <= ns < S \
                            and occ[na, nr, ns]:
                        union((a, r, s), (na, nr, ns))
    lab = np.full(occ.size, -1, np.int64)
    for (a, r, s) in idx:
        ra, rr, rs = find((a, r, s))
        lab[(a * R + r) * S + s] = (ra * R + rr) * S + rs
    return lab


def test_cc_random(rng):
    occ = rng.random((6, 10, 14)) < 0.25
    got = np.asarray(clustering.connected_components(jnp.asarray(occ)))
    want = brute_cc(occ)
    occ_flat = occ.reshape(-1)
    np.testing.assert_array_equal(got[occ_flat], want[occ_flat])
    # empty cells are self-loops
    own = np.arange(occ.size)
    np.testing.assert_array_equal(got[~occ_flat], own[~occ_flat])


def _random_grid(shape, density, seed):
    return np.random.default_rng(seed).random(shape) < density


def _seam_grid(shape, density, seed):
    return np.random.default_rng(seed + 19).random(shape) < density


def _azimuth_run_grid():
    """An isolated low-id voxel P=(0,5,10) and an occupied azimuth run
    a=5..9 at the same (range, sector): azimuth distance 5, so P must
    stay its own component (the grid does not wrap in azimuth)."""
    occ = np.zeros((12, 16, 24), bool)
    occ[0, 5, 10] = True
    occ[5:10, 5, 10] = True
    return occ


def _snake_grid():
    """A long run along sector, a diagonal hop at its end and an isolated
    voxel."""
    occ = np.zeros((6, 8, 40), bool)
    occ[2, 3, :] = True
    occ[3, 4, 39] = True
    occ[0, 0, 0] = True
    return occ


@pytest.mark.parametrize("make_occ", [
    # shape / density sweep
    lambda: _random_grid((4, 8, 16), 0.3, 0),
    lambda: _random_grid((12, 16, 24), 0.2, 0),
    lambda: _random_grid((12, 16, 24), 0.6, 0),
    # dense random grids whose components cross many azimuth slabs
    lambda: _seam_grid((12, 16, 24), 0.35, 0),
    lambda: _seam_grid((12, 16, 24), 0.35, 1),
    lambda: _seam_grid((12, 16, 24), 0.35, 2),
    _azimuth_run_grid,
    _snake_grid,
], ids=["shape4x8x16-d0.3", "shape12x16x24-d0.2", "shape12x16x24-d0.6",
        "slabs-seed0", "slabs-seed1", "slabs-seed2",
        "no-azimuth-wraparound", "snake"])
def test_cc_matches_union_find(make_occ):
    """connected_components equals the union-find oracle on every
    occupied voxel; empty voxels keep their own id."""
    occ = make_occ()
    got = np.asarray(clustering.connected_components(jnp.asarray(occ)))
    want = brute_cc(occ)
    occ_flat = occ.reshape(-1)
    np.testing.assert_array_equal(got[occ_flat], want[occ_flat])
    own = np.arange(occ.size)
    np.testing.assert_array_equal(got[~occ_flat], own[~occ_flat])


def test_cc_long_snake():
    """A single long 1-voxel-wide component exercises propagation depth."""
    occ = np.zeros((3, 4, 60), bool)
    occ[1, 1, :] = True
    got = np.asarray(clustering.connected_components(jnp.asarray(occ)))
    labs = got[occ.reshape(-1)]
    assert len(np.unique(labs)) == 1


def test_cc_no_sector_wraparound():
    """Sector 0 and sector S-1 must NOT connect (reference clamps, no wrap,
    src/ssc.cpp:402-403)."""
    occ = np.zeros((1, 1, 12), bool)
    occ[0, 0, 0] = True
    occ[0, 0, 11] = True
    got = np.asarray(clustering.connected_components(jnp.asarray(occ)))
    assert got[0] != got[11]


def test_cc_iteration_cap_terminates_early():
    """`max_iters` is a hard defensive bound (SURVEY.md 7.3): a cap of 1
    must terminate after one sweep, leaving a long multi-arm component
    under-merged, while the default cap reaches the exact fixpoint."""
    # an L-shaped path whose ends only connect through many diagonal hops:
    # diagonal staircase in (range, sector) so neither a single run-scan
    # nor one neighbour-min sweep can collapse it
    occ = np.zeros((1, 30, 30), bool)
    for i in range(30):
        occ[0, i, i] = True
        if i + 1 < 30:
            occ[0, i, i + 1] = True
    capped = np.asarray(clustering.connected_components(
        jnp.asarray(occ), max_iters=1))
    full = np.asarray(clustering.connected_components(jnp.asarray(occ)))
    occ_flat = occ.reshape(-1)
    assert len(np.unique(full[occ_flat])) == 1
    # the cap genuinely bound the iteration count: the capped run stopped
    # before the fixpoint (non-convergence is visible to callers as >1
    # label on what converges to one component)
    assert len(np.unique(capped[occ_flat])) > 1


def test_compact_labels():
    roots_pts = jnp.asarray(np.array([7, 3, 7, 9, 3, 3, 100], np.int32))
    valid = jnp.asarray(np.array([1, 1, 1, 1, 1, 1, 0], bool))
    roots, pc, n, dropped = clustering.compact_labels(roots_pts, valid,
                                                      max_clusters=8,
                                                      sentinel=1000)
    roots, pc = np.asarray(roots), np.asarray(pc)
    assert int(n) == 3 and int(dropped) == 0
    assert list(roots[:3]) == [3, 7, 9]
    np.testing.assert_array_equal(pc, [1, 0, 1, 2, 0, 0, -1])


def test_compact_labels_overflow():
    roots_pts = jnp.asarray(np.arange(10, dtype=np.int32) * 3)
    valid = jnp.ones(10, bool)
    roots, pc, n, dropped = clustering.compact_labels(roots_pts, valid,
                                                      max_clusters=4,
                                                      sentinel=1000)
    assert int(n) == 4 and int(dropped) == 6  # 6 points in dropped clusters
    pc = np.asarray(pc)
    assert np.all(pc[:4] == np.arange(4))
    assert np.all(pc[4:] == -1)


def test_compact_grid_labels_matches_point_compaction():
    """The sort-free grid compaction must agree with the point-level
    compact_labels + labels_to_grid reference on a random grid."""
    rng = np.random.default_rng(3)
    G, N, C = 500, 200, 16
    # random root structure: pick some roots, assign each occupied voxel
    # the min root <= its id (valid root_grid invariant: root <= own id,
    # root cells point to themselves)
    occupied = rng.random(G) < 0.3
    root_ids = np.where(occupied)[0]
    # group occupied voxels into runs sharing the run-min as root
    root_grid = np.arange(G, dtype=np.int32)
    cur_root = -1
    for g in range(G):
        if occupied[g]:
            if cur_root < 0 or rng.random() < 0.4:
                cur_root = g
            root_grid[g] = cur_root
        else:
            cur_root = -1
    # points: one per distinct component root first (the pipeline
    # guarantees every occupied voxel holds a point, so every grid
    # component is point-occupied), then random occupied voxels, then
    # some out-of-FOV slots
    distinct_roots = np.unique(root_grid[occupied])
    occ_ids = np.where(occupied)[0]
    flat = np.concatenate([
        distinct_roots,
        rng.choice(occ_ids, N - len(distinct_roots) - 10),
        np.full(10, -1)]).astype(np.int32)
    in_fov = flat >= 0

    roots2, pc2, lg2, n2, drop2 = clustering.compact_grid_labels(
        jnp.asarray(root_grid), jnp.asarray(occupied), jnp.asarray(flat),
        jnp.asarray(in_fov), C, G)

    point_roots = jnp.asarray(
        np.where(in_fov, root_grid[np.clip(flat, 0, G - 1)], G))
    roots1, pc1, n1, drop1 = clustering.compact_labels(
        point_roots, jnp.asarray(in_fov), C, G)
    lg1 = clustering.labels_to_grid(roots1, jnp.asarray(root_grid),
                                    jnp.asarray(occupied), G)
    np.testing.assert_array_equal(np.asarray(roots2), np.asarray(roots1))
    np.testing.assert_array_equal(np.asarray(pc2), np.asarray(pc1))
    np.testing.assert_array_equal(np.asarray(lg2), np.asarray(lg1))
    assert int(n2) == int(n1) and int(drop2) == int(drop1)


def test_grid_label_counts_weighted_and_plain():
    from dr_using_scv_od_tpu.ops import segment_ops as so
    rng = np.random.default_rng(7)
    lab = rng.integers(-1, 100, 5000).astype(np.int32)
    w = rng.integers(0, 4000, 5000).astype(np.float32)
    got_c = np.asarray(so.grid_label_counts(jnp.asarray(lab), 100))
    got_w = np.asarray(so.grid_label_counts(jnp.asarray(lab), 100,
                                            weights=jnp.asarray(w)))
    want_c = np.zeros(100, np.int64)
    want_w = np.zeros(100)
    m = lab >= 0
    np.add.at(want_c, lab[m], 1)
    np.add.at(want_w, lab[m], w[m])
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_w, want_w)  # radix-split is EXACT


def test_small_table_lookup_matches_gather():
    """The select-tree lookup must equal table[idx] for bool and
    multi-bit tables on every index shape (the hot paths use it in place
    of [G]- and [N]-shaped gathers from small tables)."""
    from dr_using_scv_od_tpu.ops import segment_ops as so
    rng = np.random.default_rng(5)
    for C, bits in ((512, 1), (421, 1), (512, 10), (64, 7)):
        if bits == 1:
            table = rng.random(C) < 0.5
        else:
            table = rng.integers(0, 2 ** bits, C)
        idx = rng.integers(0, C, 3000).astype(np.int32)
        got = np.asarray(so.small_table_lookup(
            jnp.asarray(table), jnp.asarray(idx), bits))
        np.testing.assert_array_equal(got, np.asarray(table)[idx])
        # 2-D index shape (the [F,N] vmapped use)
        idx2 = idx.reshape(30, 100)
        got2 = np.asarray(so.small_table_lookup(
            jnp.asarray(table), jnp.asarray(idx2), bits))
        np.testing.assert_array_equal(got2, np.asarray(table)[idx2])


def test_grid_label_hist2_matches_separate_calls():
    from dr_using_scv_od_tpu.ops import segment_ops as so
    rng = np.random.default_rng(8)
    lab = jnp.asarray(rng.integers(-1, 100, 5000).astype(np.int32))
    w = jnp.asarray(rng.integers(0, 131072, 5000).astype(np.float32))
    ws, cnt = so.grid_label_hist2(lab, 100, w, weight_bound=131073)
    np.testing.assert_array_equal(
        np.asarray(ws),
        np.asarray(so.grid_label_counts(lab, 100, weights=w,
                                        weight_bound=131073)))
    np.testing.assert_array_equal(
        np.asarray(cnt), np.asarray(so.grid_label_counts(lab, 100)))


def test_grid_label_counts_weight_bound_three_digits():
    """Weights >= 2^16 (possible when a degenerate cloud piles max_points
    into one voxel) stay exact when the caller declares the bound - the
    radix split grows to three digits (ADVICE r3)."""
    from dr_using_scv_od_tpu.ops import segment_ops as so
    lab = np.array([0, 0, 1, 2, 1], np.int32)
    w = np.array([131072.0, 70000.0, 65535.0, 65536.0, 1.0], np.float32)
    got = np.asarray(so.grid_label_counts(
        jnp.asarray(lab), 4, weights=jnp.asarray(w), weight_bound=131073))
    np.testing.assert_array_equal(got, [201072.0, 65536.0, 65536.0, 0.0])


def test_segment_minmax_bcast_matches_scatter():
    """The broadcast-compare bbox reduction must be bit-identical to the
    scatter formulation (same member sets, inf fill for empty segments)
    on ragged N (pad path) and with invalid/out-of-range ids."""
    from dr_using_scv_od_tpu.ops import segment_ops as so
    rng = np.random.default_rng(11)
    for N, C, block in ((5000, 37, 512), (1000, 8, 1024), (513, 5, 256)):
        x = rng.normal(size=(N, 3)).astype(np.float32)
        ids = rng.integers(-1, C, N).astype(np.int32)
        valid = rng.random(N) < 0.8
        a_min, a_max = so.segment_minmax(
            jnp.asarray(x), jnp.asarray(ids), jnp.asarray(valid), C)
        b_min, b_max = so.segment_minmax_bcast(
            jnp.asarray(x), jnp.asarray(ids), jnp.asarray(valid), C,
            block=block)
        np.testing.assert_array_equal(np.asarray(a_min), np.asarray(b_min))
        np.testing.assert_array_equal(np.asarray(a_max), np.asarray(b_max))
