#!/usr/bin/env python3
"""Which torch operations the sanitizer's guard flags on the card.

    python3 tools/torch_sync_probe.py    # needs one CUDA device

The port's guard (``repro_torch.analysis.sanitize.no_transfers``) is torch's
sync debug mode set to ``"error"``: an operation that makes the host wait for
the device raises. Torch documents that not every synchronizing operation is
covered, so this script runs, one at a time under the mode, each operation the
query and flush paths use or might use, and prints one JSON line per
operation: ``{"op": ..., "flagged": true|false, "error": ...}`` (``flagged``:
torch raised its synchronizing-operation error; ``error``: whatever it
raised), then a summary line. It exits 1 without a card.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch


def probes(dev):
    host = np.arange(4096, dtype=np.int32)
    big = torch.randint(0, 20000, (20000, 20), dtype=torch.int32, device=dev)
    few = torch.arange(8, dtype=torch.int32, device=dev)
    many = torch.arange(0, 4000, 10, dtype=torch.int32, device=dev)
    mask = big[:, 0] < 100
    idx = torch.arange(0, 20000, 7, device=dev)
    x = torch.rand(20000, 8, device=dev)
    y = torch.rand(20000, 8, device=dev)
    srt = torch.sort(many).values
    return {
        "from_numpy(x).to(dev)": lambda: torch.from_numpy(host).to(dev),
        "from_numpy(x).to(dev, non_blocking=True)":
            lambda: torch.from_numpy(host).to(dev, non_blocking=True),
        "torch.tensor(list, device=dev)": lambda: torch.tensor([1, 2, 3], device=dev),
        "torch.as_tensor(numpy, device=dev)": lambda: torch.as_tensor(host, device=dev),
        "t.cpu()": lambda: x.cpu(),
        "t.item()": lambda: x[0, 0].item(),
        "t.tolist()": lambda: few.tolist(),
        "int(t)": lambda: int(few[0]),
        "bool(t.any())": lambda: bool(mask.any()),
        "t.any() (tensor)": lambda: mask.any(),
        "torch.nonzero(t)": lambda: torch.nonzero(mask),
        "t[bool mask]": lambda: x[mask],
        "t[long index]": lambda: x[idx],
        "t[long index] = python scalar": lambda: x.__setitem__(idx, 0.0),
        "t[long index] = device tensor": lambda: x.__setitem__(idx, x[idx] + 1),
        "t[long index] = 0-dim device tensor":
            lambda: x.__setitem__(idx, torch.ones((), device=dev)),
        "t.index_put_((i, j), 0-dim device tensor)":
            lambda: x.index_put_((idx, idx % 8), torch.ones((), device=dev)),
        "t[1:] = device tensor (slice)": lambda: x.__setitem__(slice(1, None), y[:-1]),
        "t[:, 0] = device tensor (column)": lambda: x.__setitem__((slice(None), 0), x[:, 1]),
        "torch.isin(big, 8 ids)": lambda: torch.isin(big, few),
        "torch.isin(big, 400 ids)": lambda: torch.isin(big, many),
        "sort + searchsorted membership": lambda: srt[
            torch.searchsorted(srt, big).clamp_(max=srt.numel() - 1)] == big,
        "torch.unique(t)": lambda: torch.unique(big),
        "torch.sort(t)": lambda: torch.sort(big.reshape(-1)),
        "torch.searchsorted": lambda: torch.searchsorted(srt, big),
        "torch.where(c, a, scalar)": lambda: torch.where(mask[:, None], x, float("inf")),
        "torch.full / zeros / empty": lambda: (torch.full((8, 8), 1.0, device=dev),
                                               torch.zeros(8, device=dev),
                                               torch.empty(8, device=dev)),
        "t.clone()": lambda: x.clone(),
        "torch.cat": lambda: torch.cat([x, x]),
        "arange(s).repeat_interleave(int)":
            lambda: torch.arange(4, device=dev).repeat_interleave(1000),
        "torch.stack(list).sum(0)": lambda: torch.stack([x, x]).sum(dim=0),
        "torch.minimum(out=)": lambda: torch.minimum(x, x, out=torch.empty_like(x)),
        "t.amin(dim)": lambda: x.amin(dim=1),
        "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch.cuda.get_device_properties": lambda: torch.cuda.get_device_properties(dev),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_sync_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    table = probes(dev)
    torch.cuda.synchronize()
    flagged = []
    for name, fn in table.items():
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        error = None
        try:
            fn()
        except RuntimeError as e:
            error = str(e).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode(before)
        torch.cuda.synchronize()
        sync = error is not None and "synchronizing CUDA operation" in error
        if sync:
            flagged.append(name)
        print(json.dumps({"op": name, "flagged": sync, "error": error}), flush=True)
    print(json.dumps({"flagged": flagged, "probed": len(table), "torch": torch.__version__,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
