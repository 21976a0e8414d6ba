"""Core pytree data types.

The reference keeps per-frame state in STL containers
(`PointAPRI`/`Voxel`/`Cluster`/`Frame`, include/utility.h:96-185). Here every
container becomes a fixed-shape tensor batch so a whole frame is a single
pytree that flows through jit/scan/shard_map.

Conventions:
  * All point arrays are padded to `ShapeConfig.max_points`; `valid` masks
    distinguish real entries.
  * Cluster tables are padded to `ShapeConfig.max_clusters`; cluster id -1
    (or invalid mask) marks unused rows.
  * The dense curved-voxel grid replaces `unordered_map<int, Voxel>`
    (the "hash cloud", src/ssc.cpp:253-289): index = flat voxel id
    `az * R * S + r * S + s` (src/ssc.cpp:188).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree whose fields are all
    leaves (flattened in field order), with `replace(**changes)`."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[])

# Cluster type codes (reference: ssc/building_, tree_, car_ in
# config/semantickitti.yaml:57-59).
TYPE_NONE = -1
TYPE_BUILDING = 0
TYPE_TREE = 1
TYPE_CAR = 2

# Cluster motion state (reference: Cluster::state, include/utility.h:155).
STATE_UNKNOWN = -1
STATE_STATIC = 0
STATE_DYNAMIC = 1


@pytree_dataclass
class PointCloud:
    """Padded point batch: xyz [N,3] f32, intensity [N] f32, valid [N] bool.

    `label` optionally carries the raw SemanticKITTI label (uint32 as int32)
    for evaluation, mirroring how the reference stores the GT label in the
    eval cloud's intensity channel (src/ssc.cpp:1074-1078)."""

    xyz: jnp.ndarray
    intensity: jnp.ndarray
    valid: jnp.ndarray
    label: jnp.ndarray | None = None

    @property
    def n(self) -> int:
        return self.xyz.shape[0]


@pytree_dataclass
class VoxelGrid:
    """Dense curved-voxel statistics - tensor replacement of the
    reference's `hash_cloud` (src/ssc.cpp:253-289).

    All arrays are flat over the `bin_num` cells of GridConfig.shape
    (azimuth-major flattening identical to the reference's voxel id).
    """

    count: jnp.ndarray          # [G] int32   points per voxel
    intensity_mean: jnp.ndarray # [G] f32     (reference Voxel::intensity_av)
    intensity_var: jnp.ndarray  # [G] f32     (reference Voxel::intensity_cov)

    @property
    def occupied(self) -> jnp.ndarray:
        return self.count > 0


@pytree_dataclass
class ClusterTable:
    """Padded per-frame cluster set - replacement of
    `unordered_map<int, Cluster>` (include/utility.h:180).

    Row c describes compact cluster id c. `valid[c]` marks live rows.
    """

    valid: jnp.ndarray       # [C] bool
    n_points: jnp.ndarray    # [C] int32  (reference occupy_pts.size())
    n_voxels: jnp.ndarray    # [C] int32  (reference occupy_voxels.size())
    bbox_min: jnp.ndarray    # [C,3] f32  (reference Cluster::bounding_box)
    bbox_max: jnp.ndarray    # [C,3] f32
    type: jnp.ndarray        # [C] int32  TYPE_*
    state: jnp.ndarray       # [C] int32  STATE_*
    track_id: jnp.ndarray    # [C] int32  (-1 = unassigned)

    @property
    def c(self) -> int:
        return self.valid.shape[0]


@pytree_dataclass
class FrameState:
    """One processed frame (analog of `Frame`, include/utility.h:165-185).

    `label_grid` is the dense voxel -> compact-cluster-id map that the
    reference scatters into `hash_cloud[v].label` (src/ssc.cpp:387-391);
    -1 = unoccupied or unlabeled.
    `point_voxel` / `point_cluster` give, per valid point, its flat voxel id
    and compact cluster id (-1 if filtered out of the curved grid or its
    cluster was erased).
    """

    points: PointCloud          # the post-ground-removal in-FOV cloud_use
    grid: VoxelGrid
    label_grid: jnp.ndarray     # [G] int32
    clusters: ClusterTable
    point_voxel: jnp.ndarray    # [N] int32
    point_cluster: jnp.ndarray  # [N] int32
    pose: jnp.ndarray           # [4,4] f32 world_T_sensor

    # Points removed before clustering, kept for evaluation accounting
    # (reference routes them to cloud_eva_static, src/ssc.cpp:161-172):
    # 0 = in pipeline, 1 = ground, 2 = out of FOV, 3 = dropped (patchwork)
    point_route: jnp.ndarray | None = None


@pytree_dataclass
class Overflow:
    """Counters for every static-shape cap; silent truncation would corrupt
    metrics (SURVEY.md section 7.3), so each stage reports what it dropped."""

    points_dropped: jnp.ndarray      # scalar int32
    clusters_dropped: jnp.ndarray    # scalar int32
    patch_pts_dropped: jnp.ndarray   # scalar int32


def empty_overflow() -> Overflow:
    z = jnp.zeros((), jnp.int32)
    return Overflow(points_dropped=z, clusters_dropped=z, patch_pts_dropped=z)
