"""Device resolution shared by every tensor-creating entry point."""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device") -> torch.device:
    """``torch.device(device)``, raising when it names CUDA and no card
    is visible. There is no CPU fallback: a caller that wants the CPU
    asks for ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the host")
    return dev


def host_to(x, device: torch.device, dtype: "torch.dtype | None" = None
            ) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) on ``device`` without waiting
    for the device: a copy from pageable memory would first drain the
    stream, so a CUDA copy goes through pinned memory, asynchronously
    (PyTorch's pinned-memory allocator keeps the buffer until the copy
    has run)."""
    t = torch.as_tensor(x, dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
