"""dr_using_scv_od_tpu: a dynamic-aware LiDAR odometry & mapping engine
in JAX/XLA, built from scratch with the capabilities of the
SCV-OD reference (Yixin-F/DR-Using-SCV-OD).

Layer map (bottom-up; cf. SURVEY.md section 1):
  config   - typed profiles (reference: include/utility.h Utility params)
  types    - fixed-shape pytree containers (reference: utility.h structs)
  ops      - dense numeric kernels (quantize, clustering, plane, segment ops)
  models   - pipeline stages (patchwork, segmentation, recognition, tracking,
             gicp, erasor, posegraph) and the frame/window drivers
  parallel - device meshes, sharded window pipeline, ring halo exchange
  utils    - dataset IO (KITTI/PCD), synthetic scenes, timing, checkpoints
  eval     - PR/RR/F1 + IoU metrics (reference: tool/analysis.py)
"""

from . import config
from . import types

__version__ = "0.1.0"
