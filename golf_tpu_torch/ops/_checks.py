"""Input checks shared by the CUDA kernel wrappers."""

from __future__ import annotations

import torch


def check_kernel_inputs(name: str, **tensors: torch.Tensor) -> None:
    """Every tensor a kernel reads must be a contiguous fp32 CUDA tensor on
    one device, and nothing may need a gradient through the raw wrapper:
    gradients go through the autograd Functions of ``ops.lookup`` and
    ``ops.allpole``, whose backward runs the kernels again."""
    device = None
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: inputs on {device} and {t.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise NotImplementedError(
            f"{name}: the raw kernel wrapper has no backward; use the "
            f"differentiable op (ops.lookup.lookup_blocks, ops.allpole."
            f"allpole or allpole_const)")
