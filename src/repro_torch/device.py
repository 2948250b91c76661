"""Where an entry point runs: every one defaults to the GPU and refuses to
start without one unless ``device="cpu"`` is asked for."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch device of an entry point; a CUDA device must be present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but no CUDA device is available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_on(tensor: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise unless ``tensor`` lies on ``device`` (``cuda`` matches any index)."""
    here = tensor.device
    if here.type != device.type or (device.index is not None and here.index != device.index):
        raise ValueError(f"{what} lie on {here}, the call asks for {device}")
