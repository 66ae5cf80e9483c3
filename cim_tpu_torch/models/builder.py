"""Top-level CIM model (port of cim_tpu/models/builder.py).

Conv body -> MaskFuse -> cls/iou heads, with the reference's module names
(``Conv_Body``, ``Box_Head``, ``cls_iou_model``) so that a reference
checkpoint, or cim_tpu's variables through
cim_tpu_torch.utils.jax_weights.state_dict_from_jax, load unchanged.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn

from cim_tpu_torch.models.heads import ClsIouHead
from cim_tpu_torch.models.layers import torch_default_init_
from cim_tpu_torch.models.mask_fuse import MaskFuse
from cim_tpu_torch.models.resnet import ResNet50C4
from cim_tpu_torch.models.tiny import TinyConvBody
from cim_tpu_torch.utils.device import resolve_device

BACKBONES = {
    "resnet50.torch_resnet50": ResNet50C4,
    "tiny.conv_body": TinyConvBody,  # the CPU tests' body
}


class CIMModel(nn.Module):
    """forward(image (H, W, 3), rois (N, 4), masks (N, 7, 7), valid (N,),
    im_hw=None) -> dict with predict_cls / predict_det (N, C+1),
    refine_cls / refine_iou (K, N, C+1) and blob_conv (h, w, C) float32."""

    def __init__(self, conv_body: str = "resnet50.torch_resnet50",
                 num_classes: int = 20, refine_times: int = 3,
                 mlp_head_dim: int = 4096, roi_size: int = 7,
                 sampling_ratio: int = 0, max_adaptive_grid: int = 2,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if conv_body not in BACKBONES:
            raise NotImplementedError(
                f"CONV_BODY {conv_body!r} is not ported yet (ported: {sorted(BACKBONES)})"
            )
        body = BACKBONES[conv_body]
        self.body_cls = body
        self.compute_dtype = compute_dtype
        self.Conv_Body = body(device=device)
        self.Box_Head = MaskFuse(
            body.dim_out, body.spatial_scale, hidden_dim=mlp_head_dim,
            roi_size=roi_size, sampling_ratio=sampling_ratio,
            max_adaptive_grid=max_adaptive_grid, dtype=compute_dtype,
            device=device,
        )
        self.cls_iou_model = ClsIouHead(
            mlp_head_dim, num_classes, refine_times, device=device
        )

    def convbody_net(self, image, im_hw=None):
        """Conv body only: image (H, W, 3) -> features (h, w, C) float32."""
        x = image.to(self.compute_dtype).permute(2, 0, 1)[None]
        x = x.contiguous(memory_format=torch.channels_last)
        feat = self.Conv_Body(x, im_hw)[0]  # (C, h, w), NHWC in memory
        return feat.permute(1, 2, 0).float().contiguous()

    def forward(self, image, rois, masks, valid, im_hw=None) -> Dict[str, torch.Tensor]:
        """im_hw: optional (h, w) true image extent when ``image`` is a
        zero-padded bucket; it threads valid-extent masking through the
        backbone and RoIAlign, so padded and unpadded runs agree."""
        feat = self.convbody_net(image, im_hw)
        seg_x = self.Box_Head(feat, rois, masks, self.body_cls.feature_valid_hw(im_hw))
        predict_cls, predict_det, refine_cls, refine_iou = self.cls_iou_model(seg_x, valid)
        return {
            "predict_cls": predict_cls,
            "predict_det": predict_det,
            "refine_cls": refine_cls,
            "refine_iou": refine_iou,
            "blob_conv": feat,
        }


def frozen_paths_for(cfg) -> List[str]:
    """Module paths whose parameters do not train: the reference's
    FREEZE_AT stages (cim_tpu/models/builder.py frozen_paths_for; for
    ResNet-50 the stem ``res1`` and, at FREEZE_AT 2, ``res2``), or the
    whole conv body under TRAIN.FREEZE_CONV_BODY."""
    if cfg.TRAIN.FREEZE_CONV_BODY:
        return ["Conv_Body"]
    if cfg.MODEL.CONV_BODY.startswith("resnet50"):
        return [f"Conv_Body.res{i}" for i in range(1, cfg.ResNet.FREEZE_AT + 1)]
    return []


def is_frozen(name: str, frozen_paths) -> bool:
    return any(name == p or name.startswith(p + ".") for p in frozen_paths)


def build_model(cfg, device="cuda", generator: torch.Generator | None = None,
                train: bool = False) -> CIMModel:
    """CIMModel from a config AttrDict, on ``device``: the card unless the
    caller passes device="cpu".

    Precision follows cfg.TPU.PRECISION as in cim_tpu: "bf16_compute" runs
    the backbone and MaskFuse in bf16 (params stay float32) and the heads
    in float32; "f32" runs everything in float32. The RoIAlign grid cap is
    the one cim_tpu uses for the same config: max(cap, 4) when
    TPU.PALLAS_ROI_ALIGN is on, else TPU.MAX_ADAPTIVE_GRID, so both
    packages compute the same numbers. With ``generator``, conv and linear
    weights are drawn from it (PyTorch's default init); BN starts at
    identity. With ``train``, the parameters of frozen_paths_for(cfg) get
    requires_grad=False and the model is returned in training mode (BN
    statistics stay frozen buffers either way; the FrozenBN weight and bias
    train above FREEZE_AT, as in cim_tpu)."""
    device = resolve_device(device)
    if cfg.FAST_RCNN.ROI_XFORM_METHOD != "RoIAlign":
        raise NotImplementedError(
            f"ROI_XFORM_METHOD {cfg.FAST_RCNN.ROI_XFORM_METHOD!r} is not ported yet"
        )
    if bool(cfg.TPU.get("EVAL_INT8", False)):
        raise NotImplementedError("TPU.EVAL_INT8 is not ported yet")
    cap = cfg.TPU.MAX_ADAPTIVE_GRID
    if cfg.TPU.PALLAS_ROI_ALIGN:
        cap = max(cap, 4)
    model = CIMModel(
        conv_body=cfg.MODEL.CONV_BODY,
        num_classes=cfg.MODEL.NUM_CLASSES,
        refine_times=cfg.REFINE_TIMES,
        mlp_head_dim=cfg.FAST_RCNN.MLP_HEAD_DIM,
        roi_size=cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
        sampling_ratio=cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO,
        max_adaptive_grid=cap,
        compute_dtype=torch.bfloat16 if cfg.TPU.PRECISION == "bf16_compute" else torch.float32,
        device=device,
    )
    if generator is not None:
        torch_default_init_(model, generator)
    if not train:
        return model.eval()
    frozen = frozen_paths_for(cfg)
    for name, p in model.named_parameters():
        p.requires_grad_(not is_frozen(name, frozen))
    return model.train()
