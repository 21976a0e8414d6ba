"""Parameter sweeps: occupancy-threshold sensitivity.

Reproduces the reference's overlap-ratio experiment (doc/note.txt:81-101,
plotted by tool/plotPR.py): PR/RR as a function of the `occupancy`
threshold. The per-frame segmentation is shared across the sweep (the
reference re-ran the whole binary per point), and the tracking + verdict
stage runs ALL thresholds in ONE vmapped jit: occupancy is a scalar
compare in the verdict lattice, so the threshold axis batches cleanly -
one compile per sweep instead of one per threshold."""

from __future__ import annotations

from typing import Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig
from ..models import pipeline as pipeline_mod
from ..models import tracking as tracking_mod
from . import metrics


def occupancy_sweep(xyz: jnp.ndarray, intensity: jnp.ndarray,
                    valid: jnp.ndarray, poses: jnp.ndarray,
                    labels: jnp.ndarray, cfg: PipelineConfig,
                    thresholds: Sequence[float] = (0.2, 0.4, 0.5, 0.6, 0.8),
                    judged_only: bool = True,
                    compensation: bool | None = None) -> List[Dict]:
    """Returns one {threshold, pr, rr, f1} row per occupancy value.

    `compensation`: override TrackingConfig.enable_compensation for the
    sweep (None keeps cfg's setting) - the "-TC" ablation axis the
    reference's own sensitivity study never separated (doc/note.txt:83-101).
    All other tracking settings of `cfg.track` are preserved per-row
    (dataclasses.replace, not a fresh TrackingConfig).
    """
    import dataclasses

    frames = pipeline_mod.process_window(xyz, intensity, valid, poses, cfg)
    in_grid = frames.state.point_voxel >= 0
    pt_valid = in_grid & valid
    F = xyz.shape[0]
    G = cfg.grid.bin_num
    C = cfg.shapes.max_clusters

    cfg_t = cfg
    if compensation is not None:
        cfg_t = dataclasses.replace(
            cfg, track=dataclasses.replace(cfg.track,
                                           enable_compensation=compensation))

    def one_threshold(thr):
        tr = tracking_mod.track_window(
            xyz, frames.state.point_voxel, pt_valid,
            frames.state.label_grid, frames.state.clusters, poses, cfg_t,
            occupancy=thr)
        pv_safe = jnp.clip(frames.state.point_voxel, 0, G - 1)
        pc = jnp.take_along_axis(tr.label_grids, pv_safe, axis=1)
        pc = jnp.where(pt_valid, pc, -1)
        st = jnp.take_along_axis(tr.tables.state,
                                 jnp.clip(pc, 0, C - 1), axis=1)
        return (pc >= 0) & (st == 1) & valid       # removed [F,N]

    removed_all = jax.jit(jax.vmap(one_threshold))(
        jnp.asarray(thresholds, jnp.float32))      # [T,F,N]

    rows = []
    upto = F - 1 if judged_only else F
    for i, thr in enumerate(thresholds):
        m = metrics.removal_metrics(labels[:upto].reshape(-1),
                                    removed_all[i, :upto].reshape(-1),
                                    valid[:upto].reshape(-1))
        rows.append({"threshold": float(thr), "pr": m.pr, "rr": m.rr,
                     "f1": m.f1})
    return rows


def format_table(rows: List[Dict]) -> str:
    """Markdown table like BASELINE.md's sensitivity section."""
    out = ["| threshold | PR | RR | F1 |", "|---|---|---|---|"]
    for r in rows:
        out.append(f"| {r['threshold']:.1f} | {r['pr']:.2f} "
                   f"| {r['rr']:.2f} | {r['f1']:.4f} |")
    return "\n".join(out)
