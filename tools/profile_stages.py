"""Component-level device timing: each hot op timed as its own rep-loop
jit, at the semantickitti profile's full width, on the default device.

Usage: python tools/profile_stages.py [component ...]
Components: quantize cc ri3 ccrounds compact segrest patchwork recog track
gicp (default: all; also widestats compact2 segparts segparts2
compactparts recogparts trackparts). Prints one line per component to
stdout.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _loop(fn, n, *args):
    import jax
    import jax.numpy as jnp

    def run(*a):
        def body(_, acc):
            out = fn(a[0] + 1e-30 * acc, *a[1:])
            leaves = [jnp.sum(x.astype(jnp.float32)) for x in
                      jax.tree.leaves(out)
                      if hasattr(x, "dtype") and jnp.issubdtype(
                          jnp.asarray(x).dtype, jnp.number)]
            if not leaves:
                return acc + 1.0
            return acc + 1.0 + 1e-20 * jnp.sum(jnp.stack(leaves))
        return jax.lax.fori_loop(0, n, body, jnp.zeros((), jnp.float32))

    return jax.jit(run)


def timeit(name, fn, *args, reps=8):
    t0 = time.perf_counter()
    jfn = _loop(fn, reps, *args)
    np.asarray(jfn(*args))
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.asarray(jfn(*args))
    dt = (time.perf_counter() - t0) / reps
    print(f"{name:<28} {dt * 1e3:9.3f} ms   (compile+warm {t_compile:.1f}s)",
          flush=True)
    return dt


def main():
    import jax
    import jax.numpy as jnp
    from dr_using_scv_od_tpu import config
    from dr_using_scv_od_tpu.models import patchwork as pw_mod
    from dr_using_scv_od_tpu.models import recognition, segmentation
    from dr_using_scv_od_tpu.ops import clustering, quantize
    from dr_using_scv_od_tpu.utils import compile_cache, synthetic

    compile_cache.enable()
    which = set(sys.argv[1:]) or {
        "quantize", "cc", "ri3", "ccrounds", "compact", "segrest",
        "patchwork", "recog", "track", "gicp"}

    cfg = config.semantickitti()
    scene = synthetic.make_scene()
    F = 6
    win = synthetic.render_window(scene, F, cfg.shapes.max_points)
    xyz = jnp.asarray(win["xyz"])
    inten = jnp.asarray(win["intensity"])
    valid = jnp.asarray(win["valid"])
    poses = jnp.asarray(win["poses"])
    x0, i0, v0, p0 = xyz[0], inten[0], valid[0], poses[0]
    shape3 = cfg.grid.shape

    # precompute inputs for downstream pieces (one-off, uncached timing ok)
    pw = jax.jit(lambda x, v: pw_mod.estimate_ground(
        x, v, cfg.patchwork))(x0, v0)
    nonground = pw.nonground
    _, flat, in_fov = jax.jit(
        lambda x, ng: quantize.quantize(x, ng, cfg.grid))(x0, nonground)
    grid = jax.jit(lambda f, i, m: quantize.voxel_stats(
        f, i, m, cfg.grid))(flat, i0, in_fov)
    occ3 = grid.occupied.reshape(shape3)

    if "quantize" in which:
        timeit("quantize+voxel_stats",
               lambda x, i, ng: quantize.voxel_stats(
                   *(lambda t: (t[1], i, t[2]))(
                       quantize.quantize(x, ng, cfg.grid)), cfg.grid),
               x0, i0, nonground)

    if "cc" in which:
        timeit("connected_components",
               lambda o3: clustering.connected_components(
                   o3 > 0.5, cfg.seg.cc_max_iters),
               occ3.astype(jnp.float32))

    root = jax.jit(lambda o: clustering.connected_components(
        o, cfg.seg.cc_max_iters))(occ3)

    if "ri3" in which:
        timeit("refine_by_intensity",
               lambda r: segmentation.refine_by_intensity(
                   r.astype(jnp.int32), grid, cfg),
               root.astype(jnp.float32))

    if "ccrounds" in which:
        # while-loop trip count of connected_components per frame: the
        # smallest iteration cap that already reaches the fixpoint, plus
        # the one iteration that finds nothing left to change. Under the
        # frame vmap the loop runs max(trips) iterations for every frame.
        def occ_of(x, v):
            p = pw_mod.estimate_ground(x, v, cfg.patchwork)
            _, fl, fov = quantize.quantize(x, p.nonground, cfg.grid)
            return quantize.voxel_stats(fl, jnp.zeros_like(v, jnp.float32),
                                        fov, cfg.grid).occupied
        occs = jax.jit(jax.vmap(occ_of))(xyz, valid).reshape((F,) + shape3)
        cc_capped = jax.jit(jax.vmap(clustering.connected_components,
                                     in_axes=(0, None)))
        full = np.asarray(cc_capped(occs, cfg.seg.cc_max_iters))
        trips = []
        for f in range(F):
            for k in range(1, cfg.seg.cc_max_iters + 1):
                got = np.asarray(cc_capped(occs[f:f + 1], jnp.int32(k)))
                if np.array_equal(got[0], full[f]):
                    break
            trips.append(min(k + 1, cfg.seg.cc_max_iters))
        print(f"connected_components trip count per frame: {trips} "
              f"(vmapped window runs {max(trips)})", flush=True)

    if "widestats" in which:
        def wstats(x, i, ng):
            _, fl, fov = quantize.quantize(x, ng, cfg.grid)
            return quantize.voxel_stats_moments(fl, x, i, fov, cfg.grid)
        timeit("quantize+voxel_stats_moments", wstats, x0, i0, nonground)

    if "compact2" in which:
        g = cfg.grid.bin_num

        def compact2(r):
            return clustering.compact_grid_labels(
                r.astype(jnp.int32), grid.occupied, flat, in_fov,
                cfg.shapes.max_clusters, g)
        timeit("compact_grid_labels", compact2, root.astype(jnp.float32))

    if "compact" in which:
        g = cfg.grid.bin_num
        sentinel = g

        def compact(r):
            r = r.astype(jnp.int32)
            safe_flat = jnp.clip(flat, 0, g - 1)
            point_roots = jnp.where(in_fov, r[safe_flat], sentinel)
            roots, point_cluster, n, ovf = clustering.compact_labels(
                point_roots, in_fov, cfg.shapes.max_clusters, sentinel)
            lg = clustering.labels_to_grid(roots, r, grid.occupied, sentinel)
            return roots, point_cluster, lg
        timeit("compact+grid", compact, root.astype(jnp.float32))

    if "segrest" in which:
        timeit("segment_frame FULL",
               lambda x, i, ng, g_, d: segmentation.segment_frame(
                   x, i, ng, g_, d, cfg),
               x0, i0, nonground, pw.ground, pw.dropped)

    if "patchwork" in which:
        timeit("patchwork FULL",
               lambda x, v: pw_mod.estimate_ground(x, v, cfg.patchwork),
               x0, v0)
        # pieces
        P = cfg.patchwork.num_patches

        def pid_only(x, v):
            return pw_mod._patch_id(x, v, cfg.patchwork)
        timeit("  patch_id", pid_only, x0, v0)

        def hist_part(x, v):
            pid = pw_mod._patch_id(x, v, cfg.patchwork)
            NB = 128
            z = x[..., 2]
            binned = pid < P
            zbin = jnp.clip(((z + 3.2) / 8.0 * NB), 0, NB - 1).astype(jnp.int32)
            slot = jnp.where(binned, pid * NB + zbin, P * NB)
            hist = jax.ops.segment_sum(binned.astype(jnp.int32), slot,
                                       num_segments=P * NB + 1)
            return hist
        timeit("  z-histogram scatter", hist_part, x0, v0)

        def fits(x, v):
            pid = pw_mod._patch_id(x, v, cfg.patchwork)
            mask = pid < P

            def ssum(val):
                return jax.ops.segment_sum(
                    jnp.where(mask, val, 0.0), jnp.where(mask, pid, P),
                    num_segments=P + 1)[:P]
            xx, yy, zz = x[:, 0], x[:, 1], x[:, 2]
            outs = [ssum(v_) for v_ in
                    (jnp.ones_like(xx), xx, yy, zz, xx * xx, yy * yy,
                     zz * zz, xx * yy, xx * zz, yy * zz)]
            return outs
        timeit("  one plane-fit ssum x10", fits, x0, v0)

    if "segparts" in which:
        # post-kernel pieces of segment_frame, isolated (answers "where
        # do segment's ~23 device ms actually go" at round-5 state)
        from dr_using_scv_od_tpu.ops import segment_ops
        g = cfg.grid.bin_num
        C = cfg.shapes.max_clusters
        grid2, moments = jax.jit(
            lambda f, x, i, m: quantize.voxel_stats_moments(
                f, x, i, m, cfg.grid))(flat, x0, i0, in_fov)
        _, pc_, lg_, _, _ = jax.jit(
            lambda r: clustering.compact_grid_labels(
                r, grid2.occupied, flat, in_fov, C, g))(root)

        timeit("  planarity_from_moments",
               lambda c, m: recognition.voxel_planarity_from_moments(
                   c.astype(jnp.int32), m, cfg),
               grid2.count.astype(jnp.float32), moments)
        timeit("  hist_multi (nvox/npts/nplanar)",
               lambda lg: segment_ops.grid_label_hist_multi(
                   lg.astype(jnp.int32), C,
                   [grid2.count.astype(jnp.float32),
                    grid2.count.astype(jnp.float32) * 0.5],
                   weight_bound=cfg.shapes.max_points + 1),
               lg_.astype(jnp.float32))
        timeit("  bbox minmax fused",
               lambda x, pc: segment_ops.segment_minmax(
                   x, pc.astype(jnp.int32),
                   pc.astype(jnp.int32) >= 0, C),
               x0, pc_.astype(jnp.float32))
        timeit("  bbox minmax bcast",
               lambda x, pc: segment_ops.segment_minmax_bcast(
                   x, pc.astype(jnp.int32),
                   pc.astype(jnp.int32) >= 0, C),
               x0, pc_.astype(jnp.float32))
        timeit("  compare_all rank (in compact)",
               lambda r: jnp.searchsorted(
                   jnp.sort(jnp.arange(C, dtype=jnp.int32) * 997),
                   r.astype(jnp.int32), side="left",
                   method="compare_all"),
               root.astype(jnp.float32))
        timeit("  cumsum_matmul [G]",
               lambda o: clustering._cumsum_matmul(
                   (o > 0.5).astype(jnp.int32).reshape(-1)),
               occ3.astype(jnp.float32))

    if "recog" in which:
        seg, point_voxel, _ = jax.jit(
            lambda x, i, ng, g_, d: segmentation.segment_frame(
                x, i, ng, g_, d, cfg))(x0, i0, nonground, pw.ground,
                                       pw.dropped)
        timeit("recognize FULL",
               lambda x, pc, pv: recognition.recognize(
                   seg.clusters, x, pc.astype(jnp.int32),
                   pv.astype(jnp.int32), cfg),
               x0, seg.point_cluster.astype(jnp.float32),
               point_voxel.astype(jnp.float32))
        timeit("  voxel_planarity",
               lambda x, pv: recognition.voxel_planarity(
                   x, pv.astype(jnp.int32),
                   pv.astype(jnp.int32) >= 0, cfg),
               x0, point_voxel.astype(jnp.float32))

    if "track" in which:
        from dr_using_scv_od_tpu.models import pipeline, tracking
        frames = jax.jit(lambda *a: pipeline.process_window(*a, cfg))(
            xyz, inten, valid, poses)
        in_grid = frames.state.point_voxel >= 0
        timeit("tracking window(6)/frame",
               lambda x, pv, pva, lg, po: tracking.track_window(
                   x, pv.astype(jnp.int32), pva, lg.astype(jnp.int32),
                   frames.state.clusters, po, cfg),
               xyz, frames.state.point_voxel.astype(jnp.float32),
               in_grid & valid,
               frames.state.label_grid.astype(jnp.float32), poses)

    if "compactparts" in which:
        G = cfg.grid.bin_num
        g_iota = jnp.arange(G, dtype=jnp.int32)
        occv = grid.occupied

        def cumsum_only(r):
            r = r.astype(jnp.int32)
            is_root = occv & (r == g_iota)
            return jnp.cumsum(is_root.astype(jnp.int32))
        timeit("  cumsum(G)", cumsum_only, root.astype(jnp.float32))
        cid = jax.jit(cumsum_only)(root) - 1

        def gather_only(r):
            return cid[r.astype(jnp.int32)]
        timeit("  gather cid[root] (G)", gather_only,
               root.astype(jnp.float32))

        def scatter_roots(r):
            r = r.astype(jnp.int32)
            is_root = occv & (r == g_iota)
            C = cfg.shapes.max_clusters
            slot = jnp.where(is_root & (cid < C), cid, C)
            return jnp.full((C + 1,), G, jnp.int32).at[slot].set(
                g_iota, mode="drop")[:C]
        timeit("  scatter roots", scatter_roots, root.astype(jnp.float32))

        def pt_gather(r):
            lgx = r.astype(jnp.int32)
            safe = jnp.clip(flat, 0, G - 1)
            return lgx[safe]
        timeit("  point gather (N from G)", pt_gather,
               root.astype(jnp.float32))

    if "recogparts" in which:
        from dr_using_scv_od_tpu.models import recognition as rec
        from dr_using_scv_od_tpu.ops import segment_ops as so
        seg, point_voxel, _ = jax.jit(
            lambda x, i, ng, g_, d: segmentation.segment_frame(
                x, i, ng, g_, d, cfg))(x0, i0, nonground, pw.ground,
                                       pw.dropped)
        C = cfg.shapes.max_clusters
        pv = point_voxel
        pc = seg.point_cluster
        planar = jax.jit(lambda x: rec.voxel_planarity(
            x, pv, pc >= 0, cfg))(x0)

        def nplanar(x):
            pv_safe = jnp.clip(pv, 0, cfg.grid.bin_num - 1)
            pt_planar = (pc >= 0) & planar[pv_safe]
            return so.segment_count(pc, pt_planar, C)
        timeit("  planar gather+segcount", nplanar, x0)

        def bbox_feats(x):
            n_pts = jnp.maximum(seg.clusters.n_points, 1)
            dx = seg.clusters.bbox_max[:, 0] - seg.clusters.bbox_min[:, 0]
            dy = seg.clusters.bbox_max[:, 1] - seg.clusters.bbox_min[:, 1]
            from dr_using_scv_od_tpu.ops import geometry as geo
            spread = jnp.abs(geo.polar_angle_deg(seg.clusters.bbox_max)
                             - geo.polar_angle_deg(seg.clusters.bbox_min))
            return dx * dy + spread + n_pts + jnp.sum(x) * 0
        timeit("  feature math", bbox_feats, x0)

    if "segparts2" in which:
        from dr_using_scv_od_tpu.ops import segment_ops as so
        seg, point_voxel, _ = jax.jit(
            lambda x, i, ng, g_, d: segmentation.segment_frame(
                x, i, ng, g_, d, cfg))(x0, i0, nonground, pw.ground,
                                       pw.dropped)
        C = cfg.shapes.max_clusters
        pc = seg.point_cluster

        def bbox_reductions(x):
            n_points = so.segment_count(pc, pc >= 0, C)
            bmin = so.segment_min(x, pc, pc >= 0, C)
            bmax = so.segment_max(x, pc, pc >= 0, C)
            return n_points, bmin, bmax
        timeit("  bbox seg min/max/count", bbox_reductions, x0)

        def nvox_matmul(r):
            from dr_using_scv_od_tpu.ops import segment_ops as so2
            return so2.grid_label_counts(r.astype(jnp.int32), C)
        timeit("  grid_label_counts", nvox_matmul,
               seg.label_grid.astype(jnp.float32))

    if "trackparts" in which:
        from dr_using_scv_od_tpu.models import pipeline
        from dr_using_scv_od_tpu.ops import geometry
        frames = jax.jit(lambda *a: pipeline.process_window(*a, cfg))(
            xyz, inten, valid, poses)
        G = cfg.grid.bin_num
        C = cfg.shapes.max_clusters
        K = cfg.shapes.max_track_points
        pv = frames.state.point_voxel[0]
        lg0 = frames.state.label_grid[0]
        lg1 = frames.state.label_grid[1]
        import jax.tree_util as jtu
        tab0 = jax.tree.map(lambda a: a[0], frames.state.clusters)
        tab1 = jax.tree.map(lambda a: a[1], frames.state.clusters)
        T_np = jax.jit(lambda p: geometry.inverse_se3(p[1]) @ p[0])(poses)
        pva = (pv >= 0) & valid[0]

        def budget(x):
            pv_safe = jnp.clip(pv, 0, G - 1)
            pc = jnp.where(pva & (pv >= 0), lg0[pv_safe], -1)
            pc_safe = jnp.clip(pc, 0, C - 1)
            is_car = tab0.valid & (tab0.type == 2)
            pt_car = (pc >= 0) & is_car[pc_safe]
            rank = jnp.cumsum(pt_car.astype(jnp.int32)) - 1
            total = jnp.sum(pt_car)
            stride = jnp.maximum((total + K - 1) // K, 1)
            sel = pt_car & (rank % stride == 0)
            srank = jnp.cumsum(sel.astype(jnp.int32)) - 1
            slot = jnp.where(sel & (srank < K), srank, K)
            cxyz = jnp.zeros((K + 1, 3), x.dtype).at[slot].set(x)[:K]
            cpc = jnp.full((K + 1,), -1, jnp.int32).at[slot].set(
                jnp.where(sel, pc, -1))[:K]
            ccar = jnp.zeros((K + 1,), bool).at[slot].set(sel)[:K]
            return cxyz, cpc, ccar
        timeit("  budget compaction", budget, xyz[0])

        cxyz, cpc, ccar = jax.jit(budget)(xyz[0])

        def warpq(cx):
            warped = geometry.transform_points(T_np, cx)
            from dr_using_scv_od_tpu.ops import quantize as qz
            _, vflat, in_fov = qz.quantize(warped, ccar, cfg.grid)
            return vflat, in_fov
        timeit("  warp+quantize(K)", warpq, cxyz)
        vflat, in_fov = jax.jit(warpq)(cxyz)

        def dedup(vf):
            vf = vf.astype(jnp.int32)
            v_safe = jnp.clip(vf, 0, G - 1)
            nlab = jnp.where(in_fov, lg1[v_safe], -1)
            hit = in_fov & (nlab >= 0)
            key = jnp.where(hit, cpc * G + vf, jnp.iinfo(jnp.int32).max)
            order = jnp.argsort(key)
            return key[order], order
        timeit("  dedup argsort(K)", dedup, vflat.astype(jnp.float32))

        def contv(vf):
            vf = vf.astype(jnp.int32)
            v_safe = jnp.clip(vf, 0, G - 1)
            nlab = jnp.where(in_fov, lg1[v_safe], -1)
            hit = in_fov & (nlab >= 0)
            key = jnp.where(hit, cpc * G + vf, jnp.iinfo(jnp.int32).max)
            order = jnp.argsort(key)
            skey = key[order]
            uniq = jnp.concatenate([jnp.ones((1,), bool),
                                    skey[1:] != skey[:-1]]) \
                & (skey != jnp.iinfo(jnp.int32).max)
            u_c = jnp.where(uniq, cpc[order], C)
            u_l = jnp.where(uniq, nlab[order], C)
            cont = jnp.zeros((C + 1, C + 1), jnp.int32)
            cont = cont.at[u_c, u_l].add(jnp.where(uniq, 1, 0))
            return cont
        timeit("  dedup+cont scatter", contv, vflat.astype(jnp.float32))

        def nvox_seg(lgx):
            lgx = lgx.astype(jnp.int32)
            gv = lgx >= 0
            return jax.ops.segment_sum(
                gv.astype(jnp.int32), jnp.where(gv, lgx, C),
                num_segments=C + 1)[:C]
        timeit("  nvox segsum over G", nvox_seg, lg1.astype(jnp.float32))

        from dr_using_scv_od_tpu.models import tracking as trk
        def pair(x):
            return trk._pair_step(tab0, lg0, tab1, lg1, x, pv, pva,
                                  T_np, jnp.zeros((), jnp.int32), cfg)
        timeit("  _pair_step FULL", pair, xyz[0])

    if "gicp" in which:
        from dr_using_scv_od_tpu.models import gicp
        gcfg = cfg.gicp
        timeit("gicp build_voxel_map",
               lambda x, v: gicp.build_voxel_map(x, v, gcfg), x0, v0)
        vm = jax.jit(lambda x, v: gicp.build_voxel_map(x, v, gcfg))(x0, v0)
        timeit("gicp finalize_target",
               lambda n, sx, sxx: gicp.finalize_target(
                   gicp.VoxelMap(n, sx, sxx, jnp.zeros((), jnp.int32)),
                   gcfg),
               vm.n, vm.sum_x, vm.sum_xx)
        tgt = jax.jit(lambda: gicp.finalize_target(vm, gcfg))()

        def one_gn(x, v):
            import dataclasses
            c1 = dataclasses.replace(gcfg, max_iters=1)
            return gicp.register(x, v, tgt, c1).T
        timeit("gicp 1 GN iter", one_gn, xyz[1], valid[1])
        timeit("gicp register_pyramid pair",
               lambda x, v: gicp.register_pyramid(x, v, vm, gcfg).T,
               xyz[1], valid[1])


if __name__ == "__main__":
    main()
