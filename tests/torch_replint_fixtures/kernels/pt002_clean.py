"""PT002 clean twin: table and call sites match csrc/fx.cu."""
import ctypes

import torch

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fx_scale": ([_P] * 2 + [_I, ctypes.c_float, _P], _I),
    "fx_geometry": ([_I], _I),
}


def _fn(lib, name):
    raise NotImplementedError


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _plan(n):
    return n, 1.0


def scale(ids: torch.Tensor, d: torch.Tensor, dev):
    geometry = _fn("fx", "fx_geometry")
    args = (ids.data_ptr(), d.data_ptr(), *_plan(geometry(0)), _stream(dev))
    return _fn("fx", "fx_scale")(*args)
