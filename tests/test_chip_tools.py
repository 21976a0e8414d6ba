"""The chip-facing tooling on the CPU: the compile-cache location, the
benchmark's peak table and trace reduction, `chip_smoke.py`'s refusal to
run without a GPU; plus the card-vs-reference comparison, which needs a
GPU (marked `gpu`)."""

import functools
import gzip
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
from dr_using_scv_od_tpu.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield before
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    got = compile_cache.enable()
    assert got == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_cache_dir_env_var_wins(monkeypatch, tmp_path, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it stands:
    the helper reports it and sets no directory of its own."""
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == restore_cache_dir


def test_peaks_known_kind():
    bf16, tf32, hbm = bench.peaks_for("NVIDIA H100 80GB HBM3")
    assert (bf16, tf32, hbm) == (989.0, 495.0, 3.35)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H200"])
def test_peaks_unknown_kind_raises(kind):
    with pytest.raises(KeyError):
        bench.peaks_for(kind)


def _gpu_trace(tmp_path, events):
    """Write events as jax.profiler writes a perfetto trace on a GPU host:
    a "/device:GPU:0" process whose "Stream #N(...)" thread carries the
    kernels and copies, beside the "/host:CPU" process."""
    meta = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "pid": 1, "tid": 13, "name": "thread_name",
         "args": {"name": "Stream #13(MemcpyD2H,Compute,MemcpyD2D)"}},
        {"ph": "M", "pid": 1, "tid": 14, "name": "thread_name",
         "args": {"name": "Stream #14(Compute)"}},
        {"ph": "M", "pid": 701, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        {"ph": "M", "pid": 701, "tid": 5, "name": "thread_name",
         "args": {"name": "python"}},
    ]
    d = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    d.mkdir(parents=True)
    with gzip.open(d / "perfetto_trace.json.gz", "wt") as f:
        json.dump({"displayTimeUnit": "ns",
                   "traceEvents": meta + events}, f)
    return str(tmp_path)


def test_trace_device_time_is_stream_busy_union(tmp_path):
    """Busy time = union of stream event intervals (overlaps across
    streams count once); host events do not count."""
    ev = [
        {"ph": "X", "pid": 1, "tid": 13, "ts": 100.0, "dur": 50.0,
         "name": "loop_add_fusion_8"},
        {"ph": "X", "pid": 1, "tid": 14, "ts": 120.0, "dur": 60.0,
         "name": "input_reduce_fusion"},              # overlaps -> 100..180
        {"ph": "X", "pid": 1, "tid": 13, "ts": 300.0, "dur": 25.0,
         "name": "MemcpyD2D"},
        {"ph": "X", "pid": 701, "tid": 5, "ts": 0.0, "dur": 1000.0,
         "name": "PjitFunction(run)"},
    ]
    got = bench._device_ms_from_trace(_gpu_trace(tmp_path, ev))
    assert got == pytest.approx((80.0 + 25.0) / 1e3)


def test_trace_without_device_events_raises(tmp_path):
    ev = [{"ph": "X", "pid": 701, "tid": 5, "ts": 0.0, "dur": 10.0,
           "name": "PjitFunction(run)"}]
    with pytest.raises(ValueError):
        bench._device_ms_from_trace(_gpu_trace(tmp_path, ev))
    with pytest.raises(FileNotFoundError):
        bench._device_ms_from_trace(str(tmp_path / "missing"))


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in-checkout", "script-alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On a CPU-only host - in the checkout, or copied alone into an empty
    directory - chip_smoke exits non-zero and prints no JSON result."""
    cwd = ROOT
    if alone:
        cwd = tmp_path
        shutil.copy(ROOT / "chip_smoke.py", cwd / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_window_matches_cpu_reference_on_gpu(gpu_device):
    """The removal window and odometry on the card agree with the host-CPU
    reference at HIGHEST precision, within chip_smoke's tolerances, on two
    full-width frames (at tiny_test's 4,096 points GICP has ~100
    correspondences per pair, too few to pin the pose to 1 cm)."""
    import chip_smoke
    from dr_using_scv_od_tpu import config
    from dr_using_scv_od_tpu.models import odometry, pipeline
    from dr_using_scv_od_tpu.utils import synthetic

    cfg = config.semantickitti()
    win = synthetic.render_window(synthetic.make_scene(), 2,
                                  cfg.shapes.max_points)
    with jax.default_device(gpu_device):
        x, i, v, p = (jnp.asarray(win[k])
                      for k in ("xyz", "intensity", "valid", "poses"))
        res = pipeline.run_window(x, i, v, p, cfg)
        poses = np.asarray(jax.jit(functools.partial(
            odometry.estimate_window_poses, cfg=cfg))(x, v).poses)
    assert res.removed.devices() == {gpu_device}
    chip_smoke.compare_with_reference(cfg, win, res, poses)
