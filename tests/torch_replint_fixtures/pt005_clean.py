"""PT005 clean twin: metadata at import, tensors inside functions."""
import numpy as np
import torch

_INT_MAX = torch.iinfo(torch.int32).max  # metadata, no tensor
_DEV = torch.device("cuda")  # names a device without touching it
_HOST_TABLE = np.arange(1024) * 2  # host numpy is free at import


def table():
    return torch.from_numpy(_HOST_TABLE).to(_DEV)
