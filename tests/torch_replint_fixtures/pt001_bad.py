"""PT001 fixture: host syncs reachable from a guarded region."""
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

    def _gather(self, us):
        q = torch.arange(8).to(self.device)  # a blocking upload
        total = q.sum()
        if int(total) > 3:  # int() of a tensor reads it back
            return q.cpu()  # readback outside the helpers
        return q

    def _round(self):
        hit = torch.zeros(4, dtype=torch.bool)
        rows = torch.nonzero(hit)  # the count goes to the host
        return rows.tolist(), hit.any().item()
