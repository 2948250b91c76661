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


class _MetaGenerator(torch.Generator):
    """A CPU generator that names the ``meta`` device as its own: ``meta`` has
    no generator, and a draw made there gives a shape without values."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A generator seeded with ``seed`` whose ``device`` is where the draws
    land: ``device``'s own, or on ``meta`` (the dry run's shapes without
    values) a CPU one that reports ``meta``."""
    gen = _MetaGenerator() if device.type == "meta" else torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


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
