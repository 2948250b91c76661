"""PT004 fixture: 64-bit tensors handed to the kernel's 32-bit pointers."""
import torch


def _fn(lib, name):
    raise NotImplementedError


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def scale(ids: torch.Tensor, n: int, dev):
    d = torch.zeros(n, dtype=torch.float64)
    return _fn("fx", "fx_scale")(ids.long().data_ptr(), d.data_ptr(), n, 1.0, _stream(dev))
