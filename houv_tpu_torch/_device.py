"""Device resolution: entry points run on CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The torch device to run on; ``None`` means ``cuda``.

    Raises RuntimeError when a CUDA device is asked for and none is present,
    so a run never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) "
            "to run on the CPU"
        )
    return dev


def check_on(device: torch.device, *tensors: torch.Tensor) -> None:
    """Raise ValueError unless every tensor lies on ``device``'s type."""
    for t in tensors:
        if t.device.type != device.type:
            raise ValueError(
                f"tensor on {t.device} but device={device}; move it first"
            )


def exact_cuda_math() -> None:
    """The card's products as the model asks for them: f32 products in
    full f32 (TF32 off in cuBLAS and cuDNN), and bf16 products summed in
    f32 (no reduced-precision bf16 reductions in cuBLAS)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
