"""The device an entry point of the port runs on.

Entry points (build_model, Evaluator, Trainer, run_inference) run on the
card unless the caller asks for the CPU with ``device="cpu"``. There is
no silent fallback: asking for CUDA without a CUDA device is an error.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cim_tpu_torch runs on a CUDA device unless told otherwise, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"cim_tpu_torch runs on cuda or cpu, not {device}")
    return device


def check_on(module: torch.nn.Module, device: torch.device, who: str):
    """Raise unless every parameter of ``module`` lies on ``device``."""
    for name, p in module.named_parameters():
        if p.device.type != device.type or (
            device.index is not None and p.device.index != device.index
        ):
            raise ValueError(
                f"{who} runs on {device}, but parameter {name} lies on "
                f"{p.device}; build the model on the same device"
            )


@contextlib.contextmanager
def no_tf32():
    """Float32 convolutions and products for the block: TF32 off in cuDNN
    and cuBLAS (PyTorch's default allows it in cuDNN). The process-wide
    flags are restored after it."""
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    before = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b
