"""Scaling benchmark harness: frames/s at 1..N devices.

The north star requires frames/s measured at 1 chip / 1 host / N hosts
with >=80% scaling efficiency (BASELINE.json). On a CPU-only host the
harness runs on the virtual CPU mesh to validate the scaling SHAPE (the
sharded program, collective layout and efficiency accounting); on a
multi-card host the same entry point measures actual scaling.
"""

from __future__ import annotations

import time
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig
from . import mesh as mesh_mod
from . import sharded_pipeline


def measure_scaling(xyz: np.ndarray, intensity: np.ndarray,
                    valid: np.ndarray, poses: np.ndarray,
                    cfg: PipelineConfig,
                    device_counts: List[int], reps: int = 3
                    ) -> List[Dict]:
    """Runs the sharded window on 1..N devices; reports frames/s and
    efficiency vs the single-device run."""
    F = xyz.shape[0]
    rows = []
    base_fps = None
    for n in device_counts:
        if F % n != 0 or n > len(jax.devices()):
            continue
        mesh = mesh_mod.make_mesh(n, axis_names=("dp",))
        args = (jnp.asarray(xyz), jnp.asarray(intensity),
                jnp.asarray(valid), jnp.asarray(poses))
        removed, _, _ = sharded_pipeline.sharded_run_window(*args, cfg, mesh)
        np.asarray(removed[0, :1])  # sync
        t0 = time.perf_counter()
        for _ in range(reps):
            removed, _, _ = sharded_pipeline.sharded_run_window(
                *args, cfg, mesh)
            np.asarray(removed[0, :1])
        dt = (time.perf_counter() - t0) / reps
        fps = F / dt
        if base_fps is None:
            base_fps = fps
        rows.append({"devices": n, "frames_per_s": fps,
                     "efficiency": fps / (base_fps * n)})
    return rows
