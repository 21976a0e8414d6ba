"""Device mesh construction helpers.

The reference is single-process with OpenMP-only parallelism
(include/utility.h:399, SURVEY.md section 2.4); every distribution strategy
here is new design: jax.sharding meshes with XLA collectives instead of
any message-passing port.

Axis conventions:
  dp - data parallel over the frame axis (per-scan segmentation stages are
       embarrassingly parallel, the analog of the reference's serial frame
       loop src/ssc.cpp:1435-1445);
  tp - tensor parallel over the curved-voxel sector axis (splits one
       scan's grid when it exceeds a single chip's comfortable tiling).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp",)) -> Mesh:
    """Build a mesh over the first n devices (default: all)."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if shape is None:
        shape = (n_devices,)
    assert int(np.prod(shape)) == n_devices, (shape, n_devices)
    arr = np.asarray(devs).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names))


def frame_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Shard the leading (frame) axis."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
