"""PT001 clean twin: the same shape of code, every crossing through the
sanctioned helpers.

The only ``.item()`` lives in a function no guarded region reaches; the
reachable code casts dtypes and reads shapes, never values.
"""
import numpy as np
import torch

from repro_torch.analysis import sanitize


class Engine:
    def query(self, us):
        with sanitize.guard("query"):
            return self._gather(us)

    def flush(self):
        flush_guard = sanitize.guard("flush")
        with flush_guard:
            self._round()

    def _upload(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _readback(self, x):
        return x.cpu().numpy()

    def _gather(self, us):
        q = self._upload(np.arange(8)).to(torch.float32)
        b = int(q.shape[0])  # static metadata, not a device read
        return q / b

    def _round(self):
        hit = torch.zeros(4, dtype=torch.bool)
        return np.flatnonzero(self._readback(hit))


def debug_print(x):  # never reached from a guarded region
    return x.sum().item()
