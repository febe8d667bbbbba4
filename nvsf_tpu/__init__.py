"""nvsf_tpu — a JAX/XLA rebuild of Selfsupervised-NVSF.

Joint self-supervised training of LiDAR (depth + intensity + ray-drop) and camera
RGB neural fields on autonomous-driving sequences, with spatio-temporal novel-view
synthesis for both sensors including novel sensor intrinsics/extrinsics.

Layer map (mirrors SURVEY.md section 1 of the reference):
  - ops/        compute kernels (table gather/scatter, chamfer, occupancy
                compaction) — XLA instead of CUDA extensions
  - models/     neural field encoders + heads (K-planes, 4D hash grid, flow field,
                U-Net) — pure-pytree modules instead of tcnn/torch
  - render/     volume renderer (uniform + occupancy-accelerated sampling)
  - data/       datasets, device-resident ray sampling (error-map / patch / random)
  - train/      trainer (jitted train step, EMA, checkpoints, refine stage, eval)
  - parallel/   mesh construction + ray-sharded data parallelism (shard_map/psum)
  - lib/        pure conversions (lidar<->pano), ray math, poses, metrics
  - preprocess/ KITTI-360 -> pano/JSON pipeline
  - native/     C++ host-side data pipeline (pano scatter-min, .bin reader)
"""

__version__ = "0.1.0"
