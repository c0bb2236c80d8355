"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. When
no GPU is present and the caller did not ask for the CPU they raise: they
never carry on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "llm_qat_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"llm_qat_torch runs on cuda or cpu, not {dev}")
    return dev


def check_on(device: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every named tensor lies on ``device``."""
    for name, t in tensors.items():
        if t.device.type != device.type:
            raise ValueError(f"{name} lies on {t.device}, expected {device}")
