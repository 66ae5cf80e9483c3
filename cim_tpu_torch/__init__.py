"""cim_tpu_torch: the PyTorch/CUDA port of cim_tpu for NVIDIA Hopper GPUs.

A second package beside ``cim_tpu`` (the JAX reference, which stays as it
is). It mirrors cim_tpu's layout and names so each module has an obvious
counterpart, keeps the reference's public layouts (image (H, W, 3), rois
(N, 4) xyxy, masks (N, 7, 7), valid (N,)) and imports no JAX. Host code of
cim_tpu that is free of JAX (config, data, evaluation, the native C++ NMS)
is imported, not copied.

Layout:
  cim_tpu_torch.ops     RoIAlign (plain PyTorch + hand-written CUDA
                        kernel), device resize, box flip, host NMS
  cim_tpu_torch.models  ResNet-50-C4, MaskFuse, ClsIouHead, CIMModel
  cim_tpu_torch.engine  fused-TTA Evaluator and the inference loop
  cim_tpu_torch.utils   weight bridge from cim_tpu's flax variables
  cim_tpu_torch.csrc    CUDA sources, built with nvcc at first use
"""

__version__ = "0.1.0"
