"""CLI smoke tests for the offline tool analogs (remain/merge/pcd2bin/
sydney/times/intensity-report/features), covering the reference's
src/plotStatic.cpp, src/gicp.cpp, tool/pcd2bin.py, tool/car.py,
tool/time.py, tool/readIntensity.py, tool/feature.py."""

import os
import subprocess
import sys

import numpy as np
import pytest

from dr_using_scv_od_tpu.utils import artifacts, io_kitti, io_sydney


def _run(args, cwd=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "-m", "dr_using_scv_od_tpu.cli",
                           *args], capture_output=True, text=True, env=env,
                          cwd=cwd or os.getcwd(), timeout=600)


def test_remain(tmp_path, rng):
    m = rng.normal(size=(300, 4)).astype(np.float32)
    m[:, 3] = 40
    m[250:, 3] = 252                    # moving-car GT label
    io_kitti.write_pcd_xyzi(tmp_path / "static.pcd", m)
    out = tmp_path / "remain.pcd"
    r = _run(["remain", "--map", str(tmp_path / "static.pcd"),
              "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "50 remaining dynamic" in r.stdout
    assert out.exists()


def test_merge_pairs(tmp_path, rng):
    d = tmp_path / "in"
    d.mkdir()
    for i in range(4):                  # 2 (ground, nonground) pairs
        pts = rng.normal(size=(10 + i, 4)).astype(np.float32)
        io_kitti.write_pcd_xyzi(d / f"{i}.pcd", pts)
    out = tmp_path / "out"
    r = _run(["merge", "--dir", str(d), "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    m0 = io_kitti.read_pcd_xyzi(out / "0.pcd")
    m1 = io_kitti.read_pcd_xyzi(out / "1.pcd")
    assert len(m0) == 21 and len(m1) == 25
    assert (m0[:, 3] == 0).all()


def test_pcd2bin(tmp_path, rng):
    d = tmp_path / "pcd"
    d.mkdir()
    pts = rng.normal(size=(50, 4)).astype(np.float32)
    io_kitti.write_pcd_xyzi(d / "000007.pcd", pts)
    out = tmp_path / "bin"
    r = _run(["pcd2bin", "--pcd", str(d), "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    got = np.fromfile(out / "000007.bin", np.float32).reshape(-1, 4)
    np.testing.assert_array_equal(got, pts)


def test_sydney_cli(tmp_path, rng):
    rec = np.zeros(20, io_sydney.SYDNEY_DTYPE)
    rec["x"] = rng.normal(size=20).astype(np.float32)
    p = tmp_path / "car.0.bin"
    rec.tofile(p)
    out = tmp_path / "car.pcd"
    r = _run(["sydney", "--bin", str(p), "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(io_kitti.read_pcd_xyzi(out)) == 20


def test_times_cli(tmp_path):
    log = tmp_path / "time.txt"
    log.write_text("10.0\t20.0\n30.0\t40.0\n")
    r = _run(["times", "--log", str(log), "--names", "seg,track",
              "--plot", str(tmp_path / "t.png")])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "seg: 20.00 ms" in r.stdout
    assert "total: 50.00 ms over 2 frames" in r.stdout


def test_intensity_report_cli(tmp_path, rng):
    count = np.ones(32, np.int32)
    artifacts.record_intensity(tmp_path / "0",
                               count,
                               rng.uniform(0, 30, 32).astype(np.float32),
                               rng.uniform(0, 90, 32).astype(np.float32))
    r = _run(["intensity-report", "--prefix", str(tmp_path / "0"),
              "--plot", str(tmp_path / "h.png")])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "voxels=32" in r.stdout


@pytest.mark.slow
def test_features_cli(tmp_path):
    r = _run(["features", "--profile", "tiny_test", "--frames", "2",
              "--scene", "tiny", "--plot", str(tmp_path / "f.png")])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "planarity" in r.stdout


@pytest.mark.slow
def test_view_cli(tmp_path, rng):
    """tool/viewer.py analog: colored PCD -> PNG snapshot."""
    xyz = rng.normal(size=(200, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, size=(200, 3)).astype(np.float32)
    artifacts.write_colored_pcd(tmp_path / "seg.pcd",
                                np.concatenate([xyz, rgb], axis=1))
    out = tmp_path / "seg.png"
    r = _run(["view", "--pcd", str(tmp_path / "seg.pcd"),
              "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists() and out.stat().st_size > 0
    # uniform-color mode (the reference paints [0,0,1])
    r = _run(["view", "--pcd", str(tmp_path / "seg.pcd"),
              "--out", str(tmp_path / "u.png"), "--uniform"])
    assert r.returncode == 0, r.stderr[-2000:]
