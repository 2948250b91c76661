"""PT005 fixture: device work at import time."""
import torch

TABLE = torch.arange(1024) * 2  # a tensor made at import
torch.cuda.init()  # CUDA initialised at import
OFFSETS = TABLE.to("cuda")  # moved at import
