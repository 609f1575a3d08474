"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device. A CUDA request with no CUDA
    device raises; the CPU is used only when the caller names it
    (``device="cpu"``, as the tests do). Nothing falls back silently."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if device.type == "cpu":
        return device
    raise ValueError(f"horovod_tpu_torch runs on 'cuda' or 'cpu', not "
                     f"{device.type!r}")
