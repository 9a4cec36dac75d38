"""PyTorch + CUDA port of `inbed_pose_estimation_tpu` for one NVIDIA H100.

The JAX package stays the reference; this package re-implements its eval
inference path (modalities -> cascaded HMRCore -> SMPL LBS -> H36M J17 ->
MPJPE / PA-MPJPE, `evaluation/`) and the training step of the concat
family with SMPLify in the loop (`train/`, `fitting/`) in PyTorch, with
the SMPL skinning step as a CUDA kernel written for sm_90a
(`ops/csrc/skinning.cu`).  It imports nothing from the JAX package and
never imports JAX.

Entry points take `device` ("cuda" by default) and raise when CUDA is
missing unless the caller asks for "cpu" (see `device.resolve_device`).
"""
