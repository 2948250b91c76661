"""PT004 clean twin: int32 / float32 to the 32-bit pointers; the 64-bit
scratch goes to the ``unsigned long long*`` parameter it was made for, and
``.long()`` only indexes."""
import torch


def _fn(lib, name):
    raise NotImplementedError


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def pack(ids: torch.Tensor, rows: torch.Tensor, dev):
    keys = torch.empty(ids.shape[0], dtype=torch.int64)
    picked = ids[rows.long()].contiguous()
    return _fn("fx", "fx_pack")(picked.data_ptr(), keys.data_ptr(), picked.shape[0],
                                 _stream(dev))
