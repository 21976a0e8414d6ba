"""Reference-semantics oracle tests.

Direct NumPy transcriptions of the reference's two order-sensitive
algorithms serve as oracles against the vectorized array formulations:

  * `SSC::tracking`'s verdict lattice (src/ssc.cpp:1250-1426) - fuzzed
    tiny scenarios must match models/tracking._pair_step EXACTLY, given
    the two documented divergences baked into the oracle as well:
      (a) all verdicts/ratios read the PRE-mutation next-frame state (the
          reference mutates frame_next inside its cluster loop);
      (b) conflicting mutations resolve to the minimum prev-cluster row /
          minimum new row / minimum track id (deterministic; the
          reference's unordered_map iteration order is arbitrary).

  * `SSC::refineClusterByIntensity` (src/ssc.cpp:571-635) - the parallel
    min-label propagation (models/segmentation.refine_by_intensity) is
    order-free, so exact equality is not the contract; instead the fuzz
    asserts the SANDWICH
        oracle merges  <=  our merges at fixpoint  <=  predicate closure
    i.e. every fusion the reference's 3 rounds perform is performed by our
    formulation run to convergence, and every extra fusion of ours is
    justified by a chain of voxel pairs satisfying the same intensity
    predicate (src/ssc.cpp:588-595). The cadence differs by design: the
    reference fuses each cluster's whole neighbour-label SET per round
    (fast transitive growth), ours unions per voxel edge with a bounded
    per-round broadcast - the same fusion relation, reached over more
    rounds for long chains (SURVEY.md section 7.3's documented
    merge-order divergence).
"""

import dataclasses
import itertools

import numpy as np
import jax.numpy as jnp
import pytest

from dr_using_scv_od_tpu import config
from dr_using_scv_od_tpu.models import segmentation, tracking
from dr_using_scv_od_tpu.ops import clustering, quantize
from dr_using_scv_od_tpu.types import (STATE_DYNAMIC, STATE_STATIC,
                                       TYPE_CAR, ClusterTable, VoxelGrid)

INT_MAX = np.iinfo(np.int32).max


# --------------------------------------------------------------------------
# tracking oracle
# --------------------------------------------------------------------------

def _rand_se3(rng):
    w = rng.normal(scale=0.05, size=3)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = np.eye(3) + np.sinc(th / np.pi) * K \
        + (1 - np.cos(th)) / max(th * th, 1e-12) * (K @ K)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(scale=1.0, size=3)
    return T


def _make_table(C, labels_present, types, tids, nvox):
    valid = np.zeros(C, bool)
    valid[labels_present] = True
    t = np.full(C, -1, np.int32)
    t[labels_present] = types
    tid = np.full(C, -1, np.int32)
    tid[labels_present] = tids
    z3 = np.zeros((C, 3), np.float32)
    return ClusterTable(
        valid=jnp.asarray(valid), n_points=jnp.zeros(C, jnp.int32),
        n_voxels=jnp.asarray(nvox.astype(np.int32)),
        bbox_min=jnp.asarray(z3), bbox_max=jnp.asarray(z3),
        type=jnp.asarray(t), state=jnp.full((C,), -1, jnp.int32),
        track_id=jnp.asarray(tid))


def _make_scenario(rng, cfg):
    """Random consistent pair: prev points/grid/table + next grid/table."""
    C = cfg.shapes.max_clusters
    G = cfg.grid.bin_num
    N = 1024

    r = rng.uniform(cfg.grid.min_dis + 0.2, cfg.grid.max_dis - 0.2, N)
    th = rng.uniform(0.0, 2 * np.pi, N)
    el = rng.uniform(np.deg2rad(cfg.grid.min_azimuth + 2),
                     np.deg2rad(cfg.grid.max_azimuth - 2), N)
    xyz = np.stack([r * np.cos(th), r * np.sin(th), r * np.tan(el)],
                   1).astype(np.float32)
    valid = rng.random(N) < 0.95
    _, flat, _ = quantize.quantize(jnp.asarray(xyz), jnp.asarray(valid),
                                   cfg.grid)
    flat = np.asarray(flat)

    def rand_grid(occ_vox, k):
        g = np.full(G, -1, np.int32)
        g[occ_vox] = rng.integers(0, k, len(occ_vox))
        labels = np.unique(g[g >= 0])
        nvox = np.bincount(g[g >= 0], minlength=C)[:C]
        return g, labels, nvox

    k_prev = int(rng.integers(3, 10))
    prev_grid, prev_labels, prev_nvox = rand_grid(
        np.unique(flat[flat >= 0]), k_prev)

    occ2 = rng.choice(G, size=int(rng.integers(80, 400)), replace=False)
    k_next = int(rng.integers(3, 10))
    next_grid, next_labels, next_nvox = rand_grid(occ2, k_next)

    types_prev = rng.integers(0, 3, len(prev_labels))
    tids_prev = np.where(rng.random(len(prev_labels)) < 0.5,
                         rng.permutation(100)[:len(prev_labels)], -1)
    prev_table = _make_table(C, prev_labels, types_prev, tids_prev,
                             prev_nvox)
    types_next = rng.integers(0, 3, len(next_labels))
    next_table = _make_table(C, next_labels, types_next,
                             np.full(len(next_labels), -1), next_nvox)
    T_np = _rand_se3(rng)
    counter = int(rng.integers(100, 200))
    return (prev_table, prev_grid, next_table, next_grid, xyz, flat,
            valid, T_np, counter)


def oracle_pair(prev_table, prev_grid, next_table, next_grid, xyz, flat,
                valid, T_np, counter, cfg):
    """Sequential NumPy transcription of the verdict lattice
    (src/ssc.cpp:1250-1426) under the documented divergences (see module
    docstring). Returns the same observables as tracking._pair_step."""
    C = cfg.shapes.max_clusters
    occ = cfg.track.occupancy

    p_valid = np.asarray(prev_table.valid).copy()
    p_type = np.asarray(prev_table.type).copy()
    p_tid = np.asarray(prev_table.track_id).copy()
    p_state = np.asarray(prev_table.state).copy()
    n_valid = np.asarray(next_table.valid).copy()
    n_type0 = np.asarray(next_table.type)       # pre-state (divergence a)
    n_nvox0 = np.asarray(next_table.n_voxels)
    n_type = n_type0.copy()
    n_tid = np.full(C, -1, np.int32)

    # fresh track ids in ascending-row order (reference: map order,
    # src/ssc.cpp:1266-1271)
    for c in range(C):
        if p_valid[c] and p_type[c] == TYPE_CAR and p_tid[c] == -1:
            p_tid[c] = counter
            counter += 1

    # per-point prev cluster + warped next voxel (same quantize op)
    pc = np.where(valid & (flat >= 0), prev_grid[np.clip(flat, 0, None)],
                  -1)
    h = np.concatenate([xyz, np.ones((len(xyz), 1), np.float32)], 1)
    warped = (h @ T_np.T)[:, :3].astype(np.float32)
    _, wflat, in_fov = quantize.quantize(
        jnp.asarray(warped), jnp.asarray(pc >= 0), cfg.grid)
    wflat, in_fov = np.asarray(wflat), np.asarray(in_fov)

    # free rows ascending, allocated in ascending prev-row order (div. b)
    free_rows = [r for r in range(C) if not n_valid[r]]
    free_iter = iter(free_rows)

    carve = np.full(cfg.grid.bin_num, INT_MAX, np.int64)   # v -> min row
    absorb = np.full(C, INT_MAX, np.int64)                 # row -> min row
    prop = np.full(C, INT_MAX, np.int64)                   # row -> min tid
    new_rows = {}                                          # row -> (type,tid)
    n_dyn = 0

    for c in range(C):
        if not (p_valid[c] and p_type[c] == TYPE_CAR):
            continue
        pts = np.nonzero(pc == c)[0]
        if len(pts) == 0:
            continue                       # unjudged (budget rule)
        remap = {}
        for k in pts:
            if not in_fov[k]:
                continue
            l = next_grid[wflat[k]]
            if l >= 0:
                remap.setdefault(int(l), set()).add(int(wflat[k]))

        if len(remap) == 0:                         # ssc.cpp:1323-1326
            p_state[c] = STATE_DYNAMIC
            n_dyn += 1
        elif len(remap) == 1:
            l, vs = next(iter(remap.items()))
            ratio = len(vs) / max(int(n_nvox0[l]), 1)
            if ratio < occ:
                if n_type0[l] == TYPE_CAR:          # ssc.cpp:1337-1350
                    p_state[c] = STATE_DYNAMIC
                    n_dyn += 1
                else:                               # split, ssc.cpp:1351-74
                    p_state[c] = STATE_STATIC
                    p_type[c] = n_type0[l]
                    r = next(free_iter, None)
                    if r is not None:
                        new_rows[r] = (int(n_type0[l]), int(p_tid[c]))
                        for v in vs:
                            carve[v] = min(carve[v], r)
            else:
                if n_type0[l] == TYPE_CAR:          # ssc.cpp:1377-1393
                    p_state[c] = STATE_STATIC
                    prop[l] = min(prop[l], int(p_tid[c]))
                # else: state untouched (reference leaves default -1)
        else:                                       # merge, ssc.cpp:1396-1421
            p_state[c] = STATE_STATIC
            qual = [l for l, vs in remap.items()
                    if n_type0[l] == TYPE_CAR
                    and len(vs) / max(int(n_nvox0[l]), 1) >= occ]
            if qual:                # our divergence: no row for empty merge
                r = next(free_iter, None)
                if r is not None:
                    new_rows[r] = (TYPE_CAR, int(p_tid[c]))
                    for l in qual:
                        absorb[l] = min(absorb[l], r)

    # apply mutations (min-resolution, matching _pair_step's scatter-mins)
    grid_mut = next_grid.copy()
    carved = carve != INT_MAX
    grid_mut[carved] = carve[carved]
    lab = grid_mut.copy()
    absorbed_to = np.where(lab >= 0, absorb[np.clip(lab, 0, C - 1)],
                           INT_MAX)
    grid_mut = np.where(absorbed_to != INT_MAX, absorbed_to, grid_mut)

    merged_away = absorb != INT_MAX
    new_is_row = np.zeros(C, bool)
    for r, (t, tid) in new_rows.items():
        new_is_row[r] = True
        n_type[r] = t
        n_tid[r] = tid
    vmask = grid_mut >= 0
    nvox = np.bincount(grid_mut[vmask], minlength=C + 1)[:C]
    valid_next = (n_valid & ~merged_away) | new_is_row
    valid_next = valid_next & ((nvox > 0) | ~n_valid | new_is_row)
    tid_next = n_tid.copy()
    has_prop = (prop != INT_MAX) & ~new_is_row
    tid_next[has_prop] = prop[has_prop]

    return dict(p_state=p_state, p_type=p_type, p_tid=p_tid,
                grid_mut=grid_mut.astype(np.int32),
                valid_next=valid_next, type_next=n_type,
                tid_next=tid_next, nvox=nvox.astype(np.int32),
                counter=counter, n_dyn=n_dyn)


@pytest.mark.parametrize("seed", range(20))
def test_tracking_verdict_lattice_oracle(seed):
    cfg = config.tiny_test()
    rng = np.random.default_rng(seed)
    (prev_table, prev_grid, next_table, next_grid, xyz, flat, valid,
     T_np, counter) = _make_scenario(rng, cfg)

    got = tracking._pair_step(
        prev_table, jnp.asarray(prev_grid), next_table,
        jnp.asarray(next_grid), jnp.asarray(xyz), jnp.asarray(flat),
        jnp.asarray(valid), jnp.asarray(T_np),
        jnp.asarray(counter, jnp.int32), cfg)
    (prev_fin, next_mut, grid_mut, counter_out, n_dyn, row_ovf,
     pt_ovf, _pc) = got
    assert int(pt_ovf) == 0 and int(row_ovf) == 0

    want = oracle_pair(prev_table, prev_grid, next_table, next_grid,
                       xyz, flat, valid, T_np, counter, cfg)

    np.testing.assert_array_equal(np.asarray(prev_fin.state),
                                  want["p_state"], err_msg="prev states")
    np.testing.assert_array_equal(np.asarray(prev_fin.type),
                                  want["p_type"], err_msg="prev types")
    np.testing.assert_array_equal(np.asarray(prev_fin.track_id),
                                  want["p_tid"], err_msg="prev track ids")
    assert int(counter_out) == want["counter"]
    assert int(n_dyn) == want["n_dyn"]
    np.testing.assert_array_equal(np.asarray(grid_mut), want["grid_mut"],
                                  err_msg="mutated next grid")
    np.testing.assert_array_equal(np.asarray(next_mut.valid),
                                  want["valid_next"], err_msg="next valid")
    np.testing.assert_array_equal(np.asarray(next_mut.n_voxels),
                                  want["nvox"], err_msg="next n_voxels")
    live = want["valid_next"]
    np.testing.assert_array_equal(np.asarray(next_mut.type)[live],
                                  want["type_next"][live],
                                  err_msg="next types")
    np.testing.assert_array_equal(np.asarray(next_mut.track_id)[live],
                                  want["tid_next"][live],
                                  err_msg="next track ids")


# --------------------------------------------------------------------------
# RI3 oracle sandwich
# --------------------------------------------------------------------------

def _neighbors(a, r, s, rad, shape):
    A, R, S = shape
    for da, dr, ds in itertools.product(range(-rad, rad + 1), repeat=3):
        aa, rr, ss = a + da, r + dr, s + ds
        if 0 <= aa < A and 0 <= rr < R and 0 <= ss < S:
            yield aa, rr, ss


def _radius(r_idx, cfg):
    # findVoxelNeighbors shrinks to 1 beyond 0.6*range_num (ssc.cpp:397-399)
    return 1 if r_idx > cfg.grid.range_num * cfg.seg.far_range_frac \
        else cfg.seg.search_c


def _edge_ok(v, n, av, cov, cfg):
    # predicate at ssc.cpp:588-595: neighbour occupied, its variance low,
    # mean difference small
    return (cov[n] <= cfg.seg.intensity_cov
            and abs(av[v] - av[n]) <= cfg.seg.intensity_diff)


def oracle_ri3_partition(occ3, av3, cov3, labels0, cfg):
    """Sequential transcription of refineClusterByIntensity
    (src/ssc.cpp:571-635): sorted snapshot + invalid-set suppression +
    end-of-iteration fusion. Returns {voxel: partition_root}."""
    shape = occ3.shape
    vox = [tuple(v) for v in np.argwhere(occ3)]
    lab = {v: int(labels0[v]) for v in vox}

    for _ in range(cfg.seg.iteration):
        clusters = {}
        for v, l in lab.items():
            clusters.setdefault(l, []).append(v)
        # sort1 (ssc.cpp:24-26) orders by occupy_voxels DESCENDING
        # lexicographically (NB: its `>=` is UB in std::sort; descending
        # lex is the intended order)
        order = sorted(clusters, key=lambda l: sorted(clusters[l]),
                       reverse=True)
        invalid = set()
        fusions = []
        for l in order:
            if l in invalid:
                continue
            nb_vox = set()
            for (a, r, s) in clusters[l]:
                for n in _neighbors(a, r, s, _radius(r, cfg), shape):
                    if occ3[n] and _edge_ok((a, r, s), n, av3, cov3, cfg):
                        nb_vox.add(n)
            names = {lab[n] for n in nb_vox if lab[n] not in invalid}
            if len(names) > 1:
                invalid |= names
                fusions.append(names)
        for grp in fusions:
            tgt = min(grp)
            for v in vox:
                if lab[v] in grp:
                    lab[v] = tgt
    return lab


def _closure_partition(occ3, av3, cov3, labels0, cfg):
    """Union-find closure over ALL voxel pairs satisfying the predicate
    (direction-blind): the upper bound of any fusion sequence."""
    parent = {}

    def find(x):
        while parent.get(x, x) != x:
            parent[x] = parent.get(parent[x], parent[x])
            x = parent[x]
        return x

    def union(x, y):
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[max(rx, ry)] = min(rx, ry)

    vox = [tuple(int(x) for x in v) for v in np.argwhere(occ3)]
    by_label = {}
    for v in vox:
        by_label.setdefault(int(labels0[v]), []).append(v)
    for group in by_label.values():
        for v in group[1:]:
            union(group[0], v)
    for (a, r, s) in vox:
        for n in _neighbors(a, r, s, _radius(r, cfg), shape=occ3.shape):
            if occ3[n] and _edge_ok((a, r, s), n, av3, cov3, cfg):
                union((a, r, s), n)
    return {v: find(v) for v in vox}


def _groups(part):
    inv = {}
    for v, root in part.items():
        inv.setdefault(root, set()).add(v)
    return {frozenset(g) for g in inv.values()}


def _pairs(part):
    out = set()
    for g in _groups(part):
        out |= {frozenset((a, b)) for a in g for b in g if a < b}
    return out


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(6))
def test_ri3_fusion_sandwich(seed):
    cfg = config.tiny_test()
    rng = np.random.default_rng(seed + 1000)
    shape = cfg.grid.shape
    G = cfg.grid.bin_num

    occ3 = rng.random(shape) < 0.06
    av3 = rng.uniform(0, 12, shape).astype(np.float32)
    cov3 = rng.uniform(0, 2.5, shape).astype(np.float32)

    labels0 = np.asarray(clustering.connected_components(
        jnp.asarray(occ3))).reshape(shape)

    grid = VoxelGrid(count=jnp.asarray(occ3.reshape(-1).astype(np.int32)),
                     intensity_mean=jnp.asarray(av3.reshape(-1)),
                     intensity_var=jnp.asarray(cov3.reshape(-1)))
    # run ours to FIXPOINT (the contract; see module docstring): enough
    # rounds that even adversarial random chains converge
    cfg_fix = dataclasses.replace(
        cfg, seg=dataclasses.replace(cfg.seg, iteration=24))
    ours_flat = np.asarray(segmentation.refine_by_intensity(
        jnp.asarray(labels0.reshape(-1)), grid, cfg_fix))
    ours = {tuple(v): int(ours_flat[np.ravel_multi_index(tuple(v), shape)])
            for v in np.argwhere(occ3)}

    oracle = oracle_ri3_partition(occ3, av3, cov3, labels0, cfg)
    closure = _closure_partition(occ3, av3, cov3, labels0, cfg)

    p_oracle, p_ours, p_closure = _pairs(oracle), _pairs(ours), \
        _pairs(closure)
    missing = p_oracle - p_ours
    assert not missing, (f"{len(missing)} reference fusions missing from "
                         f"the array formulation, e.g. {next(iter(missing))}")
    extra = p_ours - p_closure
    assert not extra, (f"{len(extra)} array-path fusions not justified by the "
                       f"predicate closure, e.g. {next(iter(extra))}")
