"""PT002 fixture: a ctypes table and call sites out of step with csrc/fx.cu."""
import ctypes

import torch

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fx_scale": ([_P, _I, _I, ctypes.c_float, _P], _I),  # the d pointer as an int
}


def _fn(lib, name):
    raise NotImplementedError


def scale(ids: torch.Tensor, d: torch.Tensor, s: float, stream: int):
    _fn("fx", "fx_scale")(ids.data_ptr(), d.data_ptr(), ids.shape[0], s)  # stream missing
    _fn("fx", "fx_scale")(ids.data_ptr(), ids.shape[0], d.data_ptr(), s, stream)  # swapped
    return _fn("fx", "fx_missing")(ids.data_ptr())  # no such extern "C" entry
