"""Smoke test of the main path on one GPU, at the semantickitti profile's
full width (131,072-point scans, the 60 x 72 x 300 curved grid).

Run from the repository root on a machine with a GPU:

    python chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device check (a GPU or nothing) and the card's name and power limit;
  2. the dynamic-removal window as `cli segdf` runs it: a 6-frame
     synthetic window through `pipeline.run_window`, PR/RR against the
     synthetic labels;
  3. GICP window odometry as `cli odometry` runs it, ATE;
  4. the streaming `SlamEngine` as `cli slam --scene loop` runs it, for
     three windows plus the final PGO/ERASOR pass;
  5. the card against the plain reference: the same `run_window` and
     odometry on the host CPU backend at HIGHEST matmul precision, on the
     same scans;
  6. the window step's compiled memory analysis and the device's peak
     bytes in use.

The last line of stdout is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time

import numpy as np

WINDOW_FRAMES = 6
# removal floors of the synthetic drive on the CPU (tools/drive_e2e.py):
# judged frames of the default scene keep > 99 % of static points and
# reject > 95 % of moving-car points
PR_FLOOR, RR_FLOOR = 99.0, 95.0
# engine: 3 windows (6 + 5 + 5 scans, 1-frame overlap)
ENGINE_FRAMES = 16
# ATE bound of the engine run: 1 % of the distance travelled, the
# translational error that KITTI's odometry benchmark treats as good
# LiDAR odometry. The engine drifts freely here (no loop is closed within
# 16 frames of a 24-frame lap), so this bounds the front end alone.
ENGINE_ATE_FRAC = 0.01
# card-vs-reference tolerances (phase 5), with their reasons:
# scatter-adds on the GPU sum in atomic order, so per-voxel intensity
# means and variances can differ from the CPU's in the last bits; a voxel
# sitting exactly at an RI3 threshold can then flip one merge, and the
# merged cluster's verdict with it.
REMOVED_AGREE_MIN = 0.999     # share of valid points with equal verdicts
CLUSTER_COUNT_RTOL = 0.01     # per-frame cluster counts
# GICP stops once its step is under cfg.gicp.tolerance (1e-4); two
# summation orders stop at iterates a few multiples of that apart.
# 1 cm / 1 mrad is two orders above that and far below the ATE bound.
POSE_TOL_M, POSE_TOL_RAD = 0.01, 1e-3


def _log(*a):
    print(*a, flush=True)


def _phase(name):
    _log(f"== {name}")
    return time.perf_counter()


def _done(t0):
    _log(f"   ({time.perf_counter() - t0:.1f} s, compile included)")


def _rot_err(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Geodesic angle (rad) between batched rotation matrices."""
    c = (np.einsum("fij,fij->f", Ra, Rb) - 1.0) * 0.5
    return np.arccos(np.clip(c, -1.0, 1.0))


def removal_window(cfg, win):
    """Phase 2: the segdf window on the default device."""
    import jax.numpy as jnp
    from dr_using_scv_od_tpu.eval import metrics
    from dr_using_scv_od_tpu.models import pipeline

    args = [jnp.asarray(win[k])
            for k in ("xyz", "intensity", "valid", "poses")]
    compiled = pipeline.run_window.lower(*args, cfg=cfg).compile()
    res = compiled(*args)
    removed = np.asarray(res.removed)
    F = removed.shape[0]
    m = metrics.removal_metrics(win["label"][:F - 1], removed[:F - 1],
                                win["valid"][:F - 1])
    _log(f"   frames={F}  judged frames: PR={m.pr:.2f}  RR={m.rr:.2f}  "
         f"F1={m.f1:.4f}  clusters/frame="
         f"{np.asarray(res.frames.n_clusters).tolist()}")
    if not (m.pr > PR_FLOOR and m.rr > RR_FLOOR):
        raise AssertionError(f"removal below floor: PR={m.pr:.2f} "
                             f"(> {PR_FLOOR}), RR={m.rr:.2f} (> {RR_FLOOR})")
    return compiled, res


def odometry_window(cfg, win):
    """Phase 3: scan-to-scan GICP over the window, as `cli odometry`."""
    import jax
    import jax.numpy as jnp
    from dr_using_scv_od_tpu.models import odometry

    od = jax.jit(functools.partial(odometry.estimate_window_poses,
                                   cfg=cfg))(jnp.asarray(win["xyz"]),
                                             jnp.asarray(win["valid"]))
    poses = np.asarray(od.poses)
    ate = float(odometry.ate_rmse(jnp.asarray(poses),
                                  jnp.asarray(win["poses"])))
    _log(f"   ATE_rmse={ate:.4f} m  corr/pair="
         f"{np.asarray(od.n_corr).tolist()}")
    if not np.all(np.isfinite(poses)):
        raise AssertionError("odometry produced non-finite poses")
    return poses


def engine_run(cfg):
    """Phase 4: the streaming engine over a loop trajectory, configured
    as the `cli slam --scene loop --kf-dist 4.0 --loop-min-score 0.84
    --erasor-max-range 45 --erasor-max-pts 256` demo."""
    import jax.numpy as jnp
    from dr_using_scv_od_tpu.models import engine, odometry
    from dr_using_scv_od_tpu.utils import synthetic

    scene = synthetic.make_scene(synthetic.SceneSpec(
        trajectory="loop", loop_frames=24, loop_radius=18.0,
        n_moving_cars=2))
    win = synthetic.render_window(scene, ENGINE_FRAMES,
                                  cfg.shapes.max_points)
    ec = engine.EngineConfig(
        window=6, max_keyframes=128, submap_points=4096, local_map_kf=3,
        kf_dist=4.0, loop_min_gap=8, loop_min_score=0.84,
        max_loop_edges=32,
        erasor=dataclasses.replace(engine.erasor_mod.ErasorConfig(),
                                   max_range=45.0, max_pts_per_bin=256),
        erasor_every=4)
    eng = engine.SlamEngine(cfg, ec)
    for f in range(ENGINE_FRAMES):
        eng.feed(win["xyz"][f], win["intensity"][f], win["valid"][f])
    eng.finalize()
    poses = eng.poses()
    st = eng.state
    gt = win["poses"][eng.kf_frames()]
    ate = float(odometry.ate_rmse(jnp.asarray(poses), jnp.asarray(gt)))
    path = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0),
                                       axis=1)))
    bound = ENGINE_ATE_FRAC * path
    _log(f"   windows={eng.windows}  frames={eng.n_frames}  "
         f"keyframes={eng.n_keyframes}  loops={int(st.n_loops)}  "
         f"kf_overflow={int(st.kf_overflow)}  "
         f"odo_fallbacks={int(st.odo_fallbacks)}  "
         f"erasor_removed={int(st.erasor_removed)}")
    _log(f"   ATE={ate:.4f} m over a {path:.1f} m path "
         f"(bound {bound:.3f} m = {ENGINE_ATE_FRAC:.0%} of the path)")
    if eng.windows < 3:
        raise AssertionError(f"engine ran {eng.windows} windows, want 3")
    if not np.all(np.isfinite(poses)):
        raise AssertionError("engine produced non-finite poses")
    if int(st.kf_overflow) != 0:
        raise AssertionError(f"kf_overflow={int(st.kf_overflow)}")
    if not ate < bound:
        raise AssertionError(f"engine ATE {ate:.4f} m >= {bound:.3f} m")


def compare_with_reference(cfg, win, res, poses):
    """Phase 5: the same run_window and odometry on the host CPU at
    HIGHEST matmul precision, on the same scans."""
    import jax
    from dr_using_scv_od_tpu.models import odometry, pipeline

    cpu = jax.devices("cpu")[0]
    put = lambda k: jax.device_put(np.asarray(win[k]), cpu)
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        ref = pipeline.run_window(put("xyz"), put("intensity"),
                                  put("valid"), put("poses"), cfg)
        ref_poses = np.asarray(jax.jit(functools.partial(
            odometry.estimate_window_poses, cfg=cfg))(put("xyz"),
                                                      put("valid")).poses)
    valid = np.asarray(win["valid"])
    got, want = np.asarray(res.removed), np.asarray(ref.removed)
    n_diff = int(np.sum((got != want) & valid))
    agree = 1.0 - n_diff / max(int(valid.sum()), 1)
    _log(f"   removed: {n_diff} of {int(valid.sum())} valid points "
         f"disagree, agreement {agree:.6f} "
         f"(tolerance >= {REMOVED_AGREE_MIN})")
    nc_got = np.asarray(res.frames.n_clusters)
    nc_want = np.asarray(ref.frames.n_clusters)
    nc_rel = np.abs(nc_got - nc_want) / np.maximum(nc_want, 1)
    _log(f"   clusters/frame: card {nc_got.tolist()}  "
         f"reference {nc_want.tolist()}  "
         f"(tolerance {CLUSTER_COUNT_RTOL:.0%})")
    dt = np.linalg.norm(poses[:, :3, 3] - ref_poses[:, :3, 3], axis=1)
    dr = _rot_err(poses[:, :3, :3], ref_poses[:, :3, :3])
    _log(f"   odometry poses: max |dt| {dt.max():.2e} m, max |dR| "
         f"{dr.max():.2e} rad (tolerance {POSE_TOL_M} m, "
         f"{POSE_TOL_RAD} rad)")
    if agree < REMOVED_AGREE_MIN:
        raise AssertionError(f"removed agreement {agree:.6f}")
    if np.any(nc_rel > CLUSTER_COUNT_RTOL):
        raise AssertionError("cluster counts differ beyond tolerance")
    if dt.max() > POSE_TOL_M or dr.max() > POSE_TOL_RAD:
        raise AssertionError("odometry poses differ beyond tolerance")


def memory_report(compiled, device):
    """Phase 6: compiled memory analysis + the device's peak usage."""
    ma = compiled.memory_analysis()
    for field in ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "alias_size_in_bytes",
                  "generated_code_size_in_bytes"):
        _log(f"   run_window {field}: {getattr(ma, field)}")
    stats = device.memory_stats() or {}
    _log(f"   peak_bytes_in_use: {stats.get('peak_bytes_in_use')}  "
         f"bytes_limit: {stats.get('bytes_limit')}")


def run_phases(cfg):
    """Phases 2-6 on the default device (importable for a CPU rehearsal
    at a small configuration)."""
    import jax
    from dr_using_scv_od_tpu.utils import synthetic

    t0 = _phase(f"removal window: {WINDOW_FRAMES} frames x "
                f"{cfg.shapes.max_points} points, grid {cfg.grid.shape}")
    win = synthetic.render_window(synthetic.make_scene(), WINDOW_FRAMES,
                                  cfg.shapes.max_points)
    compiled, res = removal_window(cfg, win)
    _done(t0)
    t0 = _phase("GICP window odometry")
    poses = odometry_window(cfg, win)
    _done(t0)
    t0 = _phase(f"SlamEngine: {ENGINE_FRAMES} frames")
    engine_run(cfg)
    _done(t0)
    t0 = _phase("card vs host-CPU reference (HIGHEST precision)")
    compare_with_reference(cfg, win, res, poses)
    _done(t0)
    _phase("memory")
    memory_report(compiled, jax.devices()[0])


def main() -> int:
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    from dr_using_scv_od_tpu import config
    from dr_using_scv_od_tpu.utils import compile_cache

    compile_cache.enable()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    _log("card (nvidia-smi name, power.limit):")
    _log(card.stdout.strip())
    _log(f"jax {jax.__version__}: {len(jax.devices())} x "
         f"{dev.device_kind}")
    run_phases(config.semantickitti())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
