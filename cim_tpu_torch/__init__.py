"""cim_tpu_torch: the PyTorch/CUDA port of cim_tpu for NVIDIA Hopper GPUs.

A second package beside ``cim_tpu`` (the JAX reference, which stays as it
is). It mirrors cim_tpu's layout and names so each module has an obvious
counterpart, and keeps the reference's public layouts (image (H, W, 3),
rois (N, 4) xyxy, masks (N, 7, 7), valid (N,)). It imports no JAX and
nothing of cim_tpu: the JAX-free host code it needs (config, data,
evaluation, the native C++ host kernels, engine.stats) is copied here, so
the port runs where only PyTorch is installed. Entry points (build_model,
Evaluator, run_inference, Trainer) run on the card unless the caller
passes device="cpu"; the command-line tools under cim_tpu_torch.tools run
on the card unless given --device cpu, and those that run only on the host
(evaluation, pseudo-label export, thresholding, visualisation,
generate_7_7) take no device.

Layout:
  cim_tpu_torch.ops         RoIAlign (plain PyTorch + hand-written CUDA
                            kernels, forward and backward), device resize,
                            box flip, NMS, mask IoU
  cim_tpu_torch.models      ResNet-50-C4, the tiny test body, MaskFuse,
                            ClsIouHead, CIMModel
  cim_tpu_torch.mining      CIM mining and the four losses
  cim_tpu_torch.engine      fused-TTA Evaluator and inference loop (with
                            the host post-processing overlapped and the
                            fan-out over processes); the Trainer,
                            optimizers, checkpoints, stats
  cim_tpu_torch.data        config-driven datasets, roidb, the train
                            loader, synthetic fixtures
  cim_tpu_torch.evaluation  COCO / VOC evaluation, RLE, mask results
  cim_tpu_torch.native      C++ host kernels (NMS, RLE), built with g++
  cim_tpu_torch.parallel    index ranges and merges of sharded evaluation
  cim_tpu_torch.prm         the Peak Response Mapping classifier: peak
                            finding, peak backpropagation, its training
  cim_tpu_torch.tools       CLIs: train, test_net, evaluation (instance-seg
                            mAP), generate_mask_for_MaskRCNN,
                            change_mask_thr, visualize_results; pre/: the
                            offline preprocessing (generate_7_7,
                            create_cob_iou, AGPL_label_assign,
                            point_level_label_assign)
  cim_tpu_torch.utils       weight bridges from cim_tpu's flax variables,
                            device selection, IO, visualisation
  cim_tpu_torch.csrc        CUDA sources, built with nvcc at first use
"""

__version__ = "0.2.0"
