"""CLI smoke tests (the reference's executable surface, CMakeLists:82-173)."""

import subprocess
import sys
import os

import numpy as np
import pytest

from dr_using_scv_od_tpu.utils import io_kitti


def _run(args, cwd=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "-m", "dr_using_scv_od_tpu.cli",
                           *args], capture_output=True, text=True, env=env,
                          cwd=cwd or os.getcwd(), timeout=600)


@pytest.mark.slow
def test_segdf_synthetic(tmp_path):
    r = _run(["segdf", "--profile", "tiny_test", "--frames", "4",
              "--out", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "PR=" in r.stdout and "RR=" in r.stdout
    assert (tmp_path / "000000_static.pcd").exists()
    assert (tmp_path / "000003_dynamic.pcd").exists()


def test_colorize(tmp_path, rng):
    pts = rng.normal(size=(100, 4)).astype(np.float32)
    b = tmp_path / "000000.bin"
    pts.tofile(b)
    out = tmp_path / "c.pcd"
    r = _run(["colorize", "--bin", str(b), "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    got = io_kitti.read_pcd_xyzi(out)
    np.testing.assert_array_equal(got, pts)


@pytest.mark.slow
def test_evaluate_artifacts(tmp_path, rng):
    # gt: 1000 static (label 40) + 200 dynamic (label 252)
    gt = rng.normal(size=(1200, 4)).astype(np.float32) * 10
    gt[:, 3] = 40
    gt[1000:, 3] = 252
    est = gt[:1000]  # perfect removal
    io_kitti.write_pcd_xyzi(tmp_path / "gt.pcd", gt)
    io_kitti.write_pcd_xyzi(tmp_path / "est.pcd", est)
    r = _run(["evaluate", "--gt", str(tmp_path / "gt.pcd"),
              "--est", str(tmp_path / "est.pcd")])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "PR=100.00" in r.stdout
    assert "RR=100.00" in r.stdout


def test_evaluate_map_four_outcomes(tmp_path, rng):
    """ufo_evaluate analog (src/evaluate.cpp:79-145): every outcome class
    must appear with its reference color and the counts must line up."""
    from dr_using_scv_od_tpu.eval import artifact
    from dr_using_scv_od_tpu.utils import io_session

    # 4 GT points, one per outcome, far apart so matches are unambiguous
    gt = np.array([[0, 0, 0, 40],      # static, preserved      -> TP
                   [10, 0, 0, 40],     # static, removed        -> FN
                   [0, 10, 0, 252],    # dynamic, removed       -> TN
                   [10, 10, 0, 252],   # dynamic, preserved     -> FP
                   [20, 20, 0, 40]],   # matched nowhere        -> dropped
                  np.float32)
    est_static = np.array([[0, 0, 0, 0], [10, 10, 0.05, 0]], np.float32)
    est_dynamic = np.array([[10, 0.05, 0, 0], [0, 10, 0, 0]], np.float32)
    io_kitti.write_pcd_xyzi(tmp_path / "gt.pcd", gt)
    io_kitti.write_pcd_xyzi(tmp_path / "s.pcd", est_static)
    io_kitti.write_pcd_xyzi(tmp_path / "d.pcd", est_dynamic)
    out = tmp_path / "evaluate.pcd"
    r = _run(["evaluate-map", "--gt", str(tmp_path / "gt.pcd"),
              "--static", str(tmp_path / "s.pcd"),
              "--dynamic", str(tmp_path / "d.pcd"), "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "TP=1" in r.stdout and "FN=1" in r.stdout
    assert "TN=1" in r.stdout and "FP=1" in r.stdout and "dropped=1" \
        in r.stdout
    data, fields = io_session.read_pcd_fields(out)
    assert len(data) == 4
    packed = np.ascontiguousarray(data[:, 3]).view(np.uint32)
    rgb = np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF,
                    packed & 0xFF], axis=1)
    for row, want in zip(rgb, artifact.OUTCOME_COLORS):
        np.testing.assert_array_equal(row, want)


@pytest.mark.slow
def test_segdf_direct_iou(tmp_path):
    """Direct pipeline -> per-class IoU (plotObject workflow without the
    artifact detour)."""
    r = _run(["segdf", "--profile", "tiny_test", "--frames", "4", "--iou"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "IoU ground:" in r.stdout and "IoU building:" in r.stdout
    ground = float(r.stdout.split("IoU ground:")[1].split("%")[0])
    assert ground > 50.0


@pytest.mark.slow
def test_slam_cli_with_resume(tmp_path):
    """Streaming SLAM driver: run, checkpoint mid-sequence, resume."""
    r = _run(["slam", "--profile", "tiny_test", "--frames", "8",
              "--window", "4", "--ckpt-every", "4",
              "--out", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "ATE=" in r.stdout
    ate = float(r.stdout.split("ATE=")[1].split(" ")[0])
    assert ate < 0.5
    assert (tmp_path / "map_static.pcd").exists()
    assert (tmp_path / "trajectory.txt").exists()
    ckpts = sorted(tmp_path.glob("engine_*.npz"))
    assert ckpts, "no checkpoint written"
    stem = str(ckpts[0]).removesuffix(".npz")
    r2 = _run(["slam", "--profile", "tiny_test", "--frames", "8",
               "--window", "4", "--resume", stem])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed at frame" in r2.stdout
    ate2 = float(r2.stdout.split("ATE=")[1].split(" ")[0])
    assert ate2 < 0.5


@pytest.mark.slow
def test_slam_streaming_kitti_dir(tmp_path):
    """slam --data <dir>: the prefetcher-backed streaming path (scans
    decoded in a background thread, fed one at a time - constant memory
    over arbitrary sequences)."""
    from dr_using_scv_od_tpu import config
    from dr_using_scv_od_tpu.utils import synthetic
    cfg = config.tiny_test()
    spec = synthetic.SceneSpec(
        ground_pts=1500, building_pts=300, tree_pts=100, car_pts=120,
        n_buildings=2, n_trees=3, n_parked_cars=2, n_moving_cars=2,
        extent=14.0, moving_speed=4.0, ego_speed=1.0, seed=0)
    scene = synthetic.make_scene(spec)
    win = synthetic.render_window(scene, 16, cfg.shapes.max_points)
    data = tmp_path / "velodyne"
    data.mkdir()
    for f in range(16):
        v = win["valid"][f]
        pts = np.concatenate(
            [win["xyz"][f][v],
             (win["intensity"][f][v] / 255.0)[:, None]],
            axis=1).astype(np.float32)
        pts.tofile(data / f"{f:06d}.bin")
    # cfg.skip = 5 (reference default): files 0,5,10,15 stream through
    r = _run(["slam", "--profile", "tiny_test", "--data", str(data),
              "--end", "16", "--window", "4", "--out", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "frames=4" in r.stdout
    assert (tmp_path / "map_static.pcd").exists()
