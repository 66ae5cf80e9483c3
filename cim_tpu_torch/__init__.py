"""cim_tpu_torch: the PyTorch/CUDA port of cim_tpu for NVIDIA Hopper GPUs.

A second package beside ``cim_tpu`` (the JAX reference, which stays as it
is). It mirrors cim_tpu's layout and names so each module has an obvious
counterpart, and keeps the reference's public layouts (image (H, W, 3),
rois (N, 4) xyxy, masks (N, 7, 7), valid (N,)). It imports no JAX and
nothing of cim_tpu: the JAX-free host code it needs (config, data,
evaluation, the native C++ host kernels, engine.stats) is copied here, so
the port runs where only PyTorch is installed. Entry points (build_model,
Evaluator, run_inference, Trainer) run on the card unless the caller
passes device="cpu".

Layout:
  cim_tpu_torch.ops         RoIAlign (plain PyTorch + hand-written CUDA
                            kernels, forward and backward), device resize,
                            box flip, NMS
  cim_tpu_torch.models      ResNet-50-C4, the tiny test body, MaskFuse,
                            ClsIouHead, CIMModel
  cim_tpu_torch.mining      CIM mining and the four losses
  cim_tpu_torch.engine      fused-TTA Evaluator and inference loop; the
                            Trainer, optimizers, checkpoints, stats
  cim_tpu_torch.data        config-driven datasets, roidb, the train
                            loader, synthetic fixtures
  cim_tpu_torch.evaluation  COCO / VOC evaluation, RLE
  cim_tpu_torch.native      C++ host kernels (NMS, RLE), built with g++
  cim_tpu_torch.utils       weight bridge from cim_tpu's flax variables,
                            device selection
  cim_tpu_torch.csrc        CUDA sources, built with nvcc at first use
"""

__version__ = "0.2.0"
