"""Device policy of the port: where tensors live and kernels run.

The JAX package resolves a Pallas execution backend (TPU Mosaic, GPU
Triton, interpret). The port has one compiled route, the hand-written CUDA
kernels, so its policy is a device: ``"cuda"`` unless the caller asks for
the CPU. Without a CUDA device, :func:`resolve_device` raises rather than
fall back: a run that meant to measure the card must never quietly measure
the host. On a CPU tensor every kernel wrapper runs its plain PyTorch
version (the configuration of the tests).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["DEFAULT_DEVICE", "MEGAKERNEL_BUDGET", "resolve_device", "as_f32",
           "check_operand", "l2_bytes", "sm_count"]

DEFAULT_DEVICE = "cuda"

# Working-set ceiling of the megakernels (``fused_loop.block_plan_fits``):
# one CTA holds both factors in shared memory. It is the JAX package's
# gpu-triton budget, so both packages admit the megakernel at the same
# shapes; the bytes are counted on the JAX package's padded shapes, which
# bound what the CUDA kernel really holds (``fused_loop.smem_bytes``).
MEGAKERNEL_BUDGET = 192 * 2**10

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions")
        if dev.index is None:       # "cuda" -> the current card, as tensors say
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_f32(arr, device: Optional[torch.device]) -> torch.Tensor:
    """A contiguous float32 tensor on ``device`` from a tensor or an array."""
    return torch.as_tensor(arr, dtype=torch.float32,
                           device=device).contiguous()


def check_operand(t: torch.Tensor, name: str, ndim: int,
                  device: torch.device, *, factor: bool = False) -> None:
    """What every kernel wrapper requires of an operand: a contiguous
    float32 tensor of ``ndim`` dimensions on ``device`` (CPU or CUDA). A
    ``factor`` operand (the (n, r) log-features) may also be bfloat16, the
    storage half of ``precision="bf16"``; kernels accumulate in float32."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    allowed = (torch.float32, torch.bfloat16) if factor else (torch.float32,)
    if t.dtype not in allowed:
        raise TypeError(f"{name} must be "
                        f"{' or '.join(str(d) for d in allowed)}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (sizes kernel grids)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def l2_bytes(device: torch.device) -> int:
    """L2 cache of a CUDA device, bytes (where kernels stream past it)."""
    return torch.cuda.get_device_properties(device).L2_cache_size
