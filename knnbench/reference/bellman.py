"""kNN tables by the Bellman condition on the road network, in plain torch.

For a table T of k (id, distance) entries a row, one relaxation F(T) gives
each vertex v the k nearest distinct objects among its candidates: itself at
distance 0 when it is an object, and every entry (o, d) of every neighbour
u's row as (o, d + w(u, v)), an object taking its least candidate distance,
ordered by (distance, id). The exact kNN table under that order is the one
table with T == F(T): every entry of a fixed point is a path from v to its
object, so it is never below the exact distance; and an object among v's k
nearest is among the k nearest of the next vertex on a shortest path to it,
so by induction on the distance every such object reaches v's candidates at
its exact distance and is kept. So ``failing_rows`` judges a whole table
with one relaxation, and ``fixed_point`` computes one from nothing.

Integer weights keep every sum exact in float32 below 2^24. ``lowered``
holds a table in a lower precision: its distances rounded to so many
significant bits (8: bfloat16; 4: fp8 e4m3) and each row put back in
(distance, id) order. Held so, the reference is the control that the
comparison has to fail.
"""
from __future__ import annotations

import numpy as np
import torch

_INF = float("inf")


def round_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Finite values of float32 ``x`` rounded to ``bits`` significant bits
    (to nearest, ties to even); infinities kept."""
    mant, exp = torch.frexp(x)
    scale = float(2 ** bits)
    rounded = torch.ldexp(torch.round(mant * scale) / scale, exp)
    return torch.where(torch.isfinite(x), rounded, x)


class Bellman:
    """One road network's relaxation, on one device."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray,
                 device, block: int = 16384):
        n = len(indptr) - 1
        deg = np.diff(indptr)
        width = int(deg.max())
        nbr = np.full((n, width), n, np.int64)          # n: the all-padding row
        w = np.full((n, width), _INF, np.float32)
        col = np.arange(len(indices)) - np.repeat(indptr[:-1], deg)
        row = np.repeat(np.arange(n), deg)
        nbr[row, col] = indices
        w[row, col] = weights
        self.n = n
        self.device = torch.device(device)
        self.nbr = torch.from_numpy(nbr).to(self.device)
        self.w = torch.from_numpy(w).to(self.device)
        self.block = block

    def relax(self, ids: torch.Tensor, d: torch.Tensor, is_object: torch.Tensor, lo: int, hi: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """F(T) for rows [lo, hi) of the (n+1, k) table (ids, d)."""
        n, k = self.n, ids.shape[1]
        rows = torch.arange(lo, hi, device=self.device)
        nb = self.nbr[lo:hi]
        cand_ids = ids[nb].reshape(hi - lo, -1).long()
        cand_d = (d[nb] + self.w[lo:hi, :, None]).reshape(hi - lo, -1)
        obj = is_object[lo:hi]
        self_ids = torch.where(obj, rows, torch.full_like(rows, -1))[:, None]
        self_d = torch.where(obj, 0.0, _INF).to(torch.float32)[:, None]
        cand_ids = torch.cat([self_ids, cand_ids], dim=1)
        cand_d = torch.cat([self_d, cand_d], dim=1)
        bad = (cand_ids < 0) | (cand_ids >= n) | ~torch.isfinite(cand_d)
        cand_ids = torch.where(bad, n, cand_ids)
        cand_d = torch.where(bad, _INF, cand_d)
        # by (id, distance): each object's least candidate is its first
        order = torch.sort(cand_d, dim=1, stable=True).indices
        cand_ids, cand_d = cand_ids.gather(1, order), cand_d.gather(1, order)
        order = torch.sort(cand_ids, dim=1, stable=True).indices
        cand_ids, cand_d = cand_ids.gather(1, order), cand_d.gather(1, order)
        first = torch.ones_like(cand_ids, dtype=torch.bool)
        first[:, 1:] = cand_ids[:, 1:] != cand_ids[:, :-1]
        keep = first & (cand_ids < n)
        cand_ids = torch.where(keep, cand_ids, n)
        cand_d = torch.where(keep, cand_d, _INF)
        # by (distance, id): a stable sort on distance keeps the ids in order
        order = torch.sort(cand_d, dim=1, stable=True).indices[:, :k]
        out_ids, out_d = cand_ids.gather(1, order), cand_d.gather(1, order)
        out_ids = torch.where(out_ids < n, out_ids, -1).to(torch.int32)
        if out_ids.shape[1] < k:  # fewer candidate slots than k
            pad = k - out_ids.shape[1]
            out_ids = torch.cat([out_ids, out_ids.new_full((hi - lo, pad), -1)], dim=1)
            out_d = torch.cat([out_d, out_d.new_full((hi - lo, pad), _INF)], dim=1)
        return out_ids, out_d

    def object_mask(self, objects: np.ndarray) -> torch.Tensor:
        mask = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        mask[torch.from_numpy(np.asarray(objects, np.int64)).to(self.device)] = True
        return mask

    def failing_rows(self, ids: torch.Tensor, d: torch.Tensor, objects: np.ndarray) -> torch.Tensor:
        """(n+1,) bool: rows of the (n+1, k) table that differ from their
        relaxation, and the padding row n unless it is all (-1, +inf)."""
        n = self.n
        if ids.shape != d.shape or ids.shape[0] != n + 1:
            return torch.ones(n + 1, dtype=torch.bool, device=self.device)
        ids = ids.to(self.device)
        d = d.to(self.device, torch.float32)
        is_object = self.object_mask(objects)
        bad = torch.zeros(n + 1, dtype=torch.bool, device=self.device)
        for lo in range(0, n, self.block):
            hi = min(n, lo + self.block)
            f_ids, f_d = self.relax(ids, d, is_object, lo, hi)
            bad[lo:hi] = ((f_ids != ids[lo:hi]) | (f_d != d[lo:hi])).any(dim=1)
        bad[n] = bool((ids[n] != -1).any() or (d[n] != _INF).any())
        return bad

    def fixed_point(self, objects: np.ndarray, k: int, max_rounds: int = 100000
                    ) -> tuple[torch.Tensor, torch.Tensor, int]:
        """The table with T == F(T), relaxed from the objects alone, row
        blocks in turn in place; also the rounds it took."""
        n = self.n
        is_object = self.object_mask(objects)
        ids = torch.full((n + 1, k), -1, dtype=torch.int32, device=self.device)
        d = torch.full((n + 1, k), _INF, dtype=torch.float32, device=self.device)
        obj = torch.from_numpy(np.asarray(objects, np.int64)).to(self.device)
        ids[obj, 0] = obj.to(torch.int32)
        d[obj, 0] = 0.0
        for rounds in range(1, max_rounds + 1):
            changed = False
            for lo in range(0, n, self.block):
                hi = min(n, lo + self.block)
                f_ids, f_d = self.relax(ids, d, is_object, lo, hi)
                if not changed:
                    changed = bool(((f_ids != ids[lo:hi]) | (f_d != d[lo:hi])).any())
                ids[lo:hi], d[lo:hi] = f_ids, f_d
            if not changed:
                return ids, d, rounds
        raise RuntimeError(f"no fixed point after {max_rounds} rounds")


def lowered(ids: torch.Tensor, d: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The table held at ``bits`` significant bits, rows in (distance, id) order."""
    low = round_bits(d, bits)
    order = torch.sort(torch.where(ids < 0, torch.iinfo(torch.int32).max, ids), dim=1,
                       stable=True).indices
    ids, low = ids.gather(1, order), low.gather(1, order)
    order = torch.sort(low, dim=1, stable=True).indices
    return ids.gather(1, order), low.gather(1, order)
