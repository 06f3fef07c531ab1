"""Small shared helpers (counterpart of ``docqa_tpu/utils/__init__.py``)."""

from __future__ import annotations

from typing import Sequence

import torch


def round_up(n: int, quantum: int) -> int:
    """Smallest multiple of ``quantum`` >= n."""
    return -(-n // quantum) * quantum


def pick_bucket(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value, else the largest bucket."""
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  A CUDA device without a card
    raises: the port never falls back to the CPU on its own — a caller
    that wants the CPU says so with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        _pin_f32_accumulation()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ("bfloat16", "float32") -> torch dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _pin_f32_accumulation() -> None:
    """Keep cuBLAS's bf16 products in float32 to the end: PyTorch's default
    (``allow_bf16_reduced_precision_reduction = True``) lets a split-K bf16
    GEMM reduce its partial sums in bf16.  Process-wide, so it is set here,
    where the package resolves a CUDA device (every engine and the mesh
    come through :func:`resolve_device`); dtype-flow reads the assignment
    as the port's ``preferred_element_type``."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
