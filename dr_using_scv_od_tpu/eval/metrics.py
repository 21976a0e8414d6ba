"""Dynamic-removal evaluation metrics.

In-framework port of the reference's offline analysis chain
(tool/analysis.py:124-194): PR (static preservation rate), RR (dynamic
rejection rate), F1, plus per-class rejection. The reference matches the
estimated static map to ground truth with a kd 1-NN (tool/analysis.py:177);
because this framework keeps exact point identity end-to-end, the
correspondence is exact (every kept point IS a ground-truth point), which
equals the kd-NN metric at inlier threshold -> 0.

A tiled brute-force NN (eval/artifact.py:nn_distances) backs the
artifact-level variant for parity runs against externally produced maps.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

DYNAMIC_CLASSES = (252, 253, 254, 255, 256, 257, 258, 259)


class RemovalMetrics(NamedTuple):
    pr: float          # static preservation %
    rr: float          # dynamic rejection %
    f1: float
    n_static: int
    n_dynamic: int
    n_static_removed: int
    n_dynamic_removed: int


def is_dynamic_label(labels: jnp.ndarray,
                     dynamic_classes: Sequence[int] = DYNAMIC_CLASSES
                     ) -> jnp.ndarray:
    """Semantic label (lower 16 bits, tool/analysis.py:8-12) in the dynamic
    set (semantickitti.yaml:62)."""
    sem = jnp.asarray(labels).astype(jnp.uint32) & 0xFFFF
    m = jnp.zeros(sem.shape, bool)
    for c in dynamic_classes:
        m = m | (sem == c)
    return m


def removal_metrics(gt_labels: jnp.ndarray, removed: jnp.ndarray,
                    valid: jnp.ndarray,
                    dynamic_classes: Sequence[int] = DYNAMIC_CLASSES
                    ) -> RemovalMetrics:
    """PR/RR/F1 with exact correspondence.

    Args (any leading batch dims, flattened):
      gt_labels: ground-truth SemanticKITTI labels per point.
      removed:   bool - point removed from the static map (judged dynamic).
      valid:     bool - real (non-padding) points.

    PR = preserved static / all static * 100   (tool/analysis.py:189)
    RR = removed dynamic  / all dynamic * 100  (tool/analysis.py:190)
    F1 = harmonic mean of PR/100, RR/100       (tool/analysis.py:191)
    """
    gt_dyn = is_dynamic_label(gt_labels, dynamic_classes) & valid
    gt_sta = valid & ~gt_dyn
    removed = jnp.asarray(removed) & valid

    n_sta = int(jnp.sum(gt_sta))
    n_dyn = int(jnp.sum(gt_dyn))
    sta_removed = int(jnp.sum(gt_sta & removed))
    dyn_removed = int(jnp.sum(gt_dyn & removed))

    pr = 100.0 * (n_sta - sta_removed) / max(n_sta, 1)
    rr = 100.0 * dyn_removed / max(n_dyn, 1)
    p, r = pr / 100.0, rr / 100.0
    f1 = 2 * p * r / max(p + r, 1e-12)
    return RemovalMetrics(pr=pr, rr=rr, f1=f1, n_static=n_sta,
                          n_dynamic=n_dyn, n_static_removed=sta_removed,
                          n_dynamic_removed=dyn_removed)


def per_class_rejection(gt_labels: np.ndarray, removed: np.ndarray,
                        valid: np.ndarray,
                        dynamic_classes: Sequence[int] = DYNAMIC_CLASSES):
    """Per-dynamic-class rejection table (tool/analysis.py:163-171).
    Returns {class: (rejection %, n_remaining, n_all)}."""
    sem = gt_labels.astype(np.uint32) & 0xFFFF
    out = {}
    for c in dynamic_classes:
        m = (sem == c) & valid
        n_all = int(m.sum())
        if n_all == 0:
            continue
        n_remain = int((m & ~removed).sum())
        out[c] = (100.0 * (n_all - n_remain) / n_all, n_remain, n_all)
    return out


def semantic_iou(gt_labels: np.ndarray, pred_class: np.ndarray,
                 valid: np.ndarray,
                 class_map: dict[int, Tuple[int, ...]]) -> dict[int, float]:
    """Per-class IoU in the style of src/plotObject.cpp:89-146.

    class_map: predicted class id -> tuple of ground-truth semantic labels
    counted as that class.
    """
    sem = gt_labels.astype(np.uint32) & 0xFFFF
    out = {}
    for cls, gt_set in class_map.items():
        pred = (pred_class == cls) & valid
        gt = np.isin(sem, gt_set) & valid
        inter = float((pred & gt).sum())
        union = float((pred | gt).sum())
        out[cls] = 100.0 * inter / max(union, 1.0)
    return out
