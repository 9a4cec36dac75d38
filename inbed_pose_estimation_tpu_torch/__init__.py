"""PyTorch + CUDA port of `inbed_pose_estimation_tpu` for one NVIDIA H100.

The JAX package stays the reference; this package re-implements its eval
driver (split on disk -> `data/` -> cascaded HMRCore -> SMPL LBS -> H36M
J17 -> MPJPE / PA-MPJPE / PVE -> body mask through `render/` and
`ops/tri_raster.py`, `evaluation/`, behind the root CLI `eval_gpu.py`) and
its training driver (augmented split on disk -> the train step with
SMPLify in the loop -> checkpoints, eval and resume; `train/`, `fitting/`,
behind the root CLI `train_gpu.py`) in PyTorch, for every registered model
family: concat, multi-trunk, fusion and Bodies-At-Rest (`models/`; the
fusion models' body mask and Bodies-At-Rest's estimated map are
`ops/mask_raster.py`), with the SMPL skinning step as a CUDA kernel written
for sm_90a (`ops/csrc/skinning.cu`).  The host side also reads a split
through a pre-decoded crop cache (`data/crop_cache.py`, built by
`tools/build_crop_cache.py`) and crops with a native C++ kernel
(`ops/native/`).  It imports nothing from the JAX package and never imports
JAX.

Entry points take `device` ("cuda" by default) and raise when CUDA is
missing unless the caller asks for "cpu" (see `device.resolve_device`).
"""
