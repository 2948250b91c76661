"""Vertex-sharded serving engine: S logical shards of one padded table on one card.

KNN-Index's core asset is a flat, size-bounded (n+1, k) table, partitionable
by vertex, unlike the hierarchical indexes it replaces (PAPER.md Section 4).
``ShardedQueryEngine`` is the JAX package's engine of the same name
(``repro.core.sharded``) on one GPU: the tables are split row-wise into
contiguous vertex ranges, one row block a shard, and the whole ``QueryEngine``
surface (batched queries, progressive prefixes, staged updates with the fused
purge+merge flush and Jacobi repair, epochs, journals, save/load) is served on
that layout. The flush contract is the port's ``EngineCore``, shared with the
scalar engine; both engines' round loops walk the JAX engine's rounds, parts
and order, so the round counts and flush stats cannot drift.

One card, S logical shards
--------------------------
The JAX engine places one row block on each device of a 1-D mesh. One H100 is
one device, so here all S blocks live in ONE ``(S*(R+1), k)`` int32/float32
tensor pair on the card, laid out exactly as the JAX engine's global array:
shard ``s`` is rows ``[s*(R+1), (s+1)*(R+1))``, ``R`` the widest range, the
block's last row the shard's own dummy row, and every pad row ``(-1, +inf)``.
Each ``shard_map`` program of the JAX engine becomes one function over the
whole tensor: a shard's row offset localises its rows (``ops.shard_rows``),
the ``all_gather`` of the served halo rows is one gather into an ``(S*U, .)``
slab, and the ``psum`` of the presence masks is a sum over the S masks. Those
two collectives sit behind ``all_gather_served`` and ``psum_masks`` below:
the seam where a port across GPUs would call ``torch.distributed``. Nothing
here runs across GPUs.

``shards=None`` means one shard (the JAX engine: every visible device; the
mesh's device-count check has no counterpart, the check is ``1 <= S <= n``).

Layout
------
Shard ``s`` of ``S`` owns ``[starts[s], starts[s+1])``: a ``ShardLayout`` of
sorted start boundaries, equal-width (``starts[s] = s * ceil(n/S)``) by
default and uneven under a ``PartitionPlan`` with explicit or ``auto`` ranges.
Vertex ``v`` lives at padded row ``owner(v) * (R+1) + (v - starts[owner(v)])``.
The ``S*(R+1) - n`` wasted rows are reported as ``row_padding_overhead``.

Repartition-on-flush: ``stage_repartition(starts)`` (or ``repartition``, which
also flushes) stages new boundaries; the next flush re-lays the working tables
under them on the card inside its fallible region (a crash rolls back to the
old boundaries with the staged queue intact), and ``_publish_epoch`` makes the
new tables and the new layout visible together. The routing table keeps a
layout per epoch, so pinned reads on old epochs route by the OLD boundaries.

Execution
---------
* Queries: each query is routed to its owner shard (a ``searchsorted`` on
  the card) and one gather over the padded tensor serves every shard;
  bit-identical to the scalar engine.
* Flush: the delete scan and the fused purge+merge run over every shard at
  once (``ops.shard_rows_containing``, ``ops.shard_rows_purge_merge``: one K1
  launch), the coalescing and orchestration are ``EngineCore``'s.
* The flush's round loops (``_insert_frontier``, ``_repair``) are the host
  form of the JAX engine's: each round's receiver set is built on the host
  (``expand_receivers``, ``repair_receivers``; in the collective halo mode
  marked on the card and read back), split by ``bucket_parts`` into
  (width, rows) parts that run at their bucket's width, and each part's
  changed mask comes back; the converged frontier's affected mask and
  distances come back and are compacted on the host
  (``compact_candidates``). These four are pure functions of the BN-Graph
  arrays, and the scalar engine's tests hold its device-built sets to them.
* At S = 1 the padded tensor IS the scalar (n+1, k) layout and the repair and
  frontier rounds are the scalar engine's own (K2 ``sweep_merge``, K3
  ``frontier_relax_rows``). At S > 1 each round first exchanges the unique
  neighbour rows across shard boundaries, then merges shard-locally (K1); the
  frontier's fold is plain torch, as it is plain XLA in the JAX package.
* Halo modes: ``halo = "collective"`` (default) serves each round's unique
  neighbour rows into one slab on the card from an index plan the host builds
  (``_halo_plan``); a plan whose padded per-owner row count exceeds
  ``halo_capacity`` falls back for that round (``halo_fallbacks``).
  ``halo = "host"`` replays the routed gather: the set algebra in numpy, the
  unique rows fetched into host memory and sent back up: the baseline and the
  collective path's bit-identity twin. The two modes differ only in that
  route: both build the candidates (``ops.halo_candidates``) and fold the
  frontier (``ops.halo_fold_min``) on the card. The JAX package folds the
  routed frontier rows in numpy on the host; with one H100 that fold took
  13 s of a 30 s flush of a 384 x 384 road network (the flush's rounds past
  ``halo_capacity`` take this path), so the port runs it where the
  collective path does.

Epochs and routing
------------------
Ownership and epoch resolution go through ONE indirection, the
``ShardRoutingTable``: vertex -> owner shard (a ``searchsorted`` against the
start boundaries, never ``v // R``) and epoch -> the padded tensors. A flush
never writes through a tensor a published epoch serves: it clones the tables
at its first write, as the scalar engine does.

Replicated hot shards
---------------------
``set_replication({shard: R})`` expands the shard set into a slot set: slot
``j < S`` is shard ``j``'s primary, each extra replica one more slot, and
``route(vs, policy=)`` spreads a hot shard's queries over its slots
(round-robin or least-outstanding). Where the JAX engine places a replica on
another device, the port places it in another buffer on the card: each
``_publish_epoch`` copies the replicated shards' fresh blocks into that
epoch's replica buffer, so every replica is byte-identical to its primary at
every epoch. A replica fault degrades that batch to the primary path and
counts ``replica_errors``. One card seats any number of replica slots, so a
plan is never refused for want of devices (the JAX engine refuses one that
needs more devices than are visible).

Artifacts store the logical (n, k) vertex-order tables (the JAX package's
format), so an index saved at N shards loads at M shards or unsharded, by
either package.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch import trace
from repro_torch.analysis import sanitize
from repro_torch.core.bngraph import BNGraph
from repro_torch.core.construct import build_knn_tables, tables_to_index
from repro_torch.core.engine import (
    _FRONTIER_COLS,
    _MAX_REPAIR_ROUNDS,
    EngineCore,
    _frontier_affected,
    _frontier_init_prog,
    _frontier_round,
    _pow2_pad,
    _repair_round,
    load_artifact,
)
from repro_torch.core.errors import EngineConfigError, EpochError, QueryError
from repro_torch.core.index import KNNIndex
from repro_torch.core.partition import ROUTE_POLICIES, PartitionPlan, propose_starts
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

_INF = float("inf")


def all_gather_served(served: torch.Tensor) -> torch.Tensor:
    """The halo exchange: every shard's (U, ...) served rows, (S, U, ...),
    -> the (S*U, ...) receive slab every shard reads, block ``src`` holding
    shard ``src``'s rows (the JAX engine's tiled ``all_gather``). All shards
    live on one card, so the slab is the served rows end to end; across GPUs
    this is where ``torch.distributed.all_gather_into_tensor`` would go."""
    return served.reshape(-1, *served.shape[2:])


def psum_masks(masks: torch.Tensor) -> torch.Tensor:
    """The presence-mask reduction: (S, size+1) per-shard masks -> their sum
    (the JAX engine's ``psum``; ``torch.distributed.all_reduce`` across GPUs)."""
    return masks.sum(dim=0)


def unique_inverse(ids: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """``np.unique(ids, return_inverse=True)`` for vertex ids in [0, n), by a
    presence table of n entries instead of a sort: a round's neighbour lists
    hold millions of ids over n vertices."""
    present = np.zeros(n, bool)
    present[ids] = True
    uniq = np.flatnonzero(present)
    rank = np.cumsum(present) - 1
    return uniq, rank[ids]


# the flush rounds' host set algebra (module doc, Execution)


def bucket_parts(deg: np.ndarray, widths: list[int], rows: np.ndarray) -> list:
    """Split a row batch by BNS-degree width bucket: ``(width, rows)`` for
    each non-empty bucket, in bucket order, a row of degree d in the first
    bucket whose width is >= d (degree-0 rows in none). ``deg`` is the
    packed BNS degree a vertex, ``widths`` the engine's ``_bucket_widths``.

    Shared by the repair and frontier rounds: each part runs against the
    (n+1, width) adjacency slice of its bucket, so the per-round work is
    sized to the batch, not to the global tau'. The split is a pure function
    of the row ids and is the JAX engine's, so the engines walk the same
    round trajectory."""
    d = deg[rows]
    parts, prev = [], 0
    for t in widths:
        part = rows[(d > prev) & (d <= t)]
        prev = t
        if part.size:
            parts.append((t, part))
    return parts


def expand_receivers(indptr: np.ndarray, indices: np.ndarray, active: np.ndarray) -> np.ndarray:
    """The next frontier round's receiver set: the union of the BNS
    neighbourhoods of the changed vertices ``active``, sorted, through the
    packed adjacency's CSR pair (it touches exactly the live edges, no
    padded columns)."""
    starts = indptr[active]
    counts = indptr[active + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int32)
    exc = np.concatenate([[0], np.cumsum(counts)[:-1]])
    idx = np.repeat(starts - exc, counts) + np.arange(total)
    return np.unique(indices[idx]).astype(np.int32)


def repair_receivers(lo_ids: np.ndarray, hi_ids: np.ndarray, changed: np.ndarray,
                     rows: np.ndarray) -> np.ndarray:
    """The next repair round's active set: the BNS neighbourhoods of the
    rows that ``changed`` (``lo_ids`` and ``hi_ids`` of the BN-Graph),
    narrowed to the purged rows ``rows``, sorted."""
    nbrs = np.unique(np.concatenate([lo_ids[changed].ravel(), hi_ids[changed].ravel()]))
    return np.intersect1d(nbrs[nbrs >= 0], rows).astype(np.int32)


def compact_candidates(
    rows: np.ndarray, aff: np.ndarray, dvals: np.ndarray, src: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(touched rows, (R, B) affected mask + distances) -> the flush's
    per-row candidate arrays: rows with no affected column dropped, the
    affected columns compacted to the front in source order, width
    pow2-padded; the exact layout the host frontier builds, so
    ``_purge_merge`` sees identical inputs either way."""
    keep = aff.any(axis=1)
    rows, aff, dvals = rows[keep], aff[keep], dvals[keep]
    if rows.size == 0:
        return rows, np.empty((0, 1), np.int32), np.empty((0, 1), np.float32)
    p = _pow2_pad(int(aff.sum(axis=1).max()), lo=4)
    if p > aff.shape[1]:
        pad = ((0, 0), (0, p - aff.shape[1]))
        aff = np.pad(aff, pad)
        dvals = np.pad(dvals, pad, constant_values=np.inf)
        src = np.pad(src, (0, p - len(src)), constant_values=-1)
    order = np.argsort(~aff, axis=1, kind="stable")[:, :p]
    taken = np.take_along_axis(aff, order, axis=1)
    cand_ids = np.where(taken, src[order], -1).astype(np.int32)
    cand_d = np.where(
        taken, np.take_along_axis(dvals, order, axis=1), np.inf
    ).astype(np.float32)
    return rows, cand_ids, cand_d


def shard_tables(vk_ids: torch.Tensor, vk_d: torch.Tensor, n: int, num_shards: int, *,
                 starts=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-lay (n+1, k) tables into the padded (S*(R+1), k) layout with one
    gather on their device through the padded-row -> source-row map (pad rows
    read the dummy row n); no host readback. ``starts=None`` is the
    equal-width split."""
    layout = (ShardLayout.equal(n, num_shards) if starts is None
              else ShardLayout.from_starts(n, starts))
    src = np.full(num_shards * layout.block, n, np.int64)
    v = np.arange(n, dtype=np.int64)
    src[layout.padded_rows(v)] = v
    src_t = torch.from_numpy(src).to(vk_ids.device)
    return vk_ids[src_t].contiguous(), vk_d[src_t].contiguous()


class ShardLayout:
    """Immutable row layout of one epoch: boundaries + uniform block size.

    ``starts`` is the sorted shard-start vector (first entry 0); shard ``s``
    owns ``[starts[s], starts[s+1])`` and every shard's block is padded to
    ``shard_rows = max range width`` rows plus one dummy gather row. The
    routing table keeps one ``ShardLayout`` per published epoch.
    """

    __slots__ = ("n", "num_shards", "starts", "shard_rows")

    def __init__(self, n: int, starts: np.ndarray, shard_rows: int):
        self.n = int(n)
        self.starts = np.asarray(starts, np.int64)
        self.num_shards = len(self.starts)
        self.shard_rows = int(shard_rows)

    @classmethod
    def equal(cls, n: int, num_shards: int) -> "ShardLayout":
        """The default split: ``starts[s] = s * ceil(n/S)`` (trailing shards
        may be empty when S nearly divides n)."""
        rows = -(-int(n) // int(num_shards))  # ceil
        return cls(n, np.arange(num_shards, dtype=np.int64) * rows, rows)

    @classmethod
    def from_starts(cls, n: int, starts) -> "ShardLayout":
        """An explicit (possibly uneven) boundary vector, validated: first
        boundary 0, strictly increasing, every shard's range non-empty."""
        arr = np.asarray(starts, np.int64).reshape(-1)
        if not arr.size or arr[0] != 0:
            raise EngineConfigError(
                f"shard range boundaries must start at vertex 0, got {arr.tolist()!r}")
        if arr.size > 1 and not np.all(np.diff(arr) > 0):
            raise EngineConfigError(
                f"shard range boundaries must be strictly increasing, got {arr.tolist()!r}")
        if int(arr[-1]) > max(int(n) - 1, 0):
            raise EngineConfigError(
                f"shard range boundary {int(arr[-1])} leaves an empty range "
                f"(vertices end at {int(n) - 1})")
        widths = np.diff(np.append(arr, int(n)))
        return cls(n, arr, int(widths.max()))

    @property
    def block(self) -> int:
        """Rows a shard holds, its dummy gather row included."""
        return self.shard_rows + 1

    @property
    def widths(self) -> np.ndarray:
        """Owned vertices per shard (0 for an empty trailing shard)."""
        return np.maximum(np.diff(np.append(self.starts, self.n)), 0)

    @property
    def is_equal(self) -> bool:
        rows = -(-self.n // self.num_shards)
        return self.shard_rows == rows and bool(
            np.array_equal(self.starts, np.arange(self.num_shards, dtype=np.int64) * rows))

    def same_as(self, other: "ShardLayout") -> bool:
        return self is other or (
            self.shard_rows == other.shard_rows and np.array_equal(self.starts, other.starts))

    def owner(self, vs: np.ndarray) -> np.ndarray:
        """Owner shard per vertex. ``vs`` must lie in [0, n] (n is the dummy
        address); anything outside raises ``QueryError``."""
        vs = np.asarray(vs, np.int64)
        if vs.size and (int(vs.min()) < 0 or int(vs.max()) > self.n):
            bad = vs[(vs < 0) | (vs > self.n)]
            raise QueryError(
                f"vertex id {int(bad[0])} is outside [0, {self.n}] and cannot be routed to a shard")
        return np.minimum(np.searchsorted(self.starts, vs, side="right") - 1, self.num_shards - 1)

    def padded_rows(self, vs: np.ndarray, own: np.ndarray | None = None) -> np.ndarray:
        """Padded row of each vertex: the owner's block base plus the vertex's
        offset from the owner's start boundary."""
        vs = np.asarray(vs, np.int64)
        if own is None:
            own = self.owner(vs)
        return own * self.block + (vs - self.starts[own])


class ShardRoutingTable:
    """The single shard indirection: vertex -> owner shard -> buffers per epoch.

    * Ownership: ``owner(vs)`` searches the current ``ShardLayout``'s start
      boundaries; ``layout(epoch)`` gives a retained epoch's own layout, so a
      pinned read on an epoch published before a repartition still routes by
      the old boundaries.
    * Epoch resolution: ``publish(epoch, buffers)`` records the padded
      tensors serving an epoch in the step the engine's ``EpochStore`` swap
      runs; ``shard_buffers(epoch)`` resolves shard -> its block.
    * Replication: ``set_replication({shard: extras})`` expands the shard set
      into a slot set (slot ``j < S`` is shard ``j``'s primary, each extra
      replica appends one slot); ``route(vs, policy=)`` resolves each query to
      a slot under ``round_robin`` or ``least_outstanding``. An epoch's
      replica buffers ride the same ``publish`` call (``serving=``).
    """

    def __init__(self, n: int, num_shards: int, starts=None):
        self.n = int(n)
        self.num_shards = int(num_shards)
        if starts is None:
            self._layout = ShardLayout.equal(self.n, self.num_shards)
        else:
            self._layout = ShardLayout.from_starts(self.n, starts)
            if self._layout.num_shards != self.num_shards:
                raise EngineConfigError(
                    f"boundary vector names {self._layout.num_shards} shards, "
                    f"table has {self.num_shards}")
        self._layout_by_epoch: dict[int, ShardLayout] = {}
        self._by_epoch: OrderedDict[int, tuple] = OrderedDict()
        self._serving_by_epoch: dict[int, tuple | None] = {}
        self.replication: dict[int, int] = {}
        self.slot_shard = np.arange(self.num_shards, dtype=np.int64)
        self._slots_of: dict[int, np.ndarray] = {}
        self._rr: dict[int, int] = {}
        self.outstanding = np.zeros(self.num_shards, np.int64)

    @property
    def current_layout(self) -> ShardLayout:
        return self._layout

    def set_layout(self, layout: ShardLayout) -> None:
        """Swap the CURRENT layout; published epochs keep theirs."""
        if layout.n != self.n or layout.num_shards != self.num_shards:
            raise EngineConfigError(
                f"layout is for n={layout.n} x {layout.num_shards} shards, "
                f"table is n={self.n} x {self.num_shards}")
        self._layout = layout

    @property
    def shard_rows(self) -> int:
        return self._layout.shard_rows

    @property
    def starts(self) -> np.ndarray:
        """The current layout's shard-start boundary vector (copy)."""
        return self._layout.starts.copy()

    def owner(self, vs: np.ndarray) -> np.ndarray:
        """Owner shard per vertex under the CURRENT layout."""
        return self._layout.owner(vs)

    def padded_rows(self, vs: np.ndarray, own: np.ndarray | None = None) -> np.ndarray:
        """Padded row per vertex under the CURRENT layout."""
        return self._layout.padded_rows(vs, own)

    @property
    def num_slots(self) -> int:
        return len(self.slot_shard)

    def set_replication(self, plan: dict[int, int]) -> np.ndarray:
        """Install a shard -> extra-replica-count plan; returns the new slot ->
        shard map. Slot ``j < num_shards`` stays shard ``j``'s primary; each
        extra replica appends one slot, grouped by shard in ascending order.
        Resets the routing cursors."""
        clean: dict[int, int] = {}
        for s, r in (plan or {}).items():
            s, r = int(s), int(r)
            if not 0 <= s < self.num_shards:
                raise EngineConfigError(
                    f"replication plan names shard {s}, have {self.num_shards}")
            if r < 0:
                raise EngineConfigError(f"replica count for shard {s} must be >= 0, got {r}")
            if r:
                clean[s] = r
        self.replication = clean
        extras: list[int] = []
        self._slots_of = {}
        for s in sorted(clean):
            slots = [s]
            for _ in range(clean[s]):
                extras.append(s)
                slots.append(self.num_shards + len(extras) - 1)
            self._slots_of[s] = np.asarray(slots, np.int64)
        self.slot_shard = np.concatenate(
            [np.arange(self.num_shards, dtype=np.int64), np.asarray(extras, np.int64)])
        self._rr = {}
        self.outstanding = np.zeros(self.num_slots, np.int64)
        return self.slot_shard

    def route(self, vs: np.ndarray, policy: str = "round_robin") -> tuple[np.ndarray, np.ndarray]:
        """(owner shard, serving slot) per vertex. Every slot of a shard serves
        byte-identical buffers, so the choice moves load, never results."""
        own = self.owner(vs)
        return own, self.assign_slots(own, policy)

    def assign_slots(self, own: np.ndarray, policy: str = "round_robin") -> np.ndarray:
        if policy not in ROUTE_POLICIES:
            raise QueryError(
                f"unknown replica routing policy {policy!r} "
                f"(want 'round_robin' or 'least_outstanding')")
        own = np.asarray(own, np.int64)
        slots = own.copy()  # primary slot id == shard id
        for s, sl in self._slots_of.items():
            m = np.flatnonzero(own == s)
            if not len(m):
                continue
            if policy == "round_robin":
                base = self._rr.get(s, 0)
                slots[m] = sl[(base + np.arange(len(m))) % len(sl)]
                self._rr[s] = (base + len(m)) % len(sl)
            else:
                slots[m] = np.repeat(sl, self._water_fill(sl, len(m)))
        return slots

    def _water_fill(self, sl: np.ndarray, count: int) -> np.ndarray:
        """Per-slot assignment counts that level ``outstanding`` + this batch
        across the shard's slots (the least-outstanding policy)."""
        load = self.outstanding[sl]
        lo, hi = int(load.min()), int(load.min()) + count
        while lo < hi:  # the highest level the batch can fill to
            mid = (lo + hi + 1) // 2
            if int(np.maximum(0, mid - load).sum()) <= count:
                lo = mid
            else:
                hi = mid - 1
        add = np.maximum(0, lo - load)
        rem = count - int(add.sum())
        if rem:
            add[np.argsort(load + add, kind="stable")[:rem]] += 1
        return add

    def record_dispatch(self, slots: np.ndarray) -> None:
        self.outstanding += np.bincount(slots, minlength=self.num_slots)

    def record_complete(self, slots: np.ndarray) -> None:
        self.outstanding -= np.bincount(slots, minlength=self.num_slots)

    # -- epoch -> buffers ----------------------------------------------

    def publish(self, epoch: int, buffers: tuple, keep=None, serving=None) -> None:
        """Swap in an epoch's buffers and, under a replication plan, its
        replica buffers, as one step; the CURRENT layout is recorded as the
        epoch's layout in the same step."""
        epoch = int(epoch)
        self._by_epoch[epoch] = buffers
        self._serving_by_epoch[epoch] = serving
        self._layout_by_epoch.setdefault(epoch, self._layout)
        if keep is not None:
            self.trim(keep)

    def trim(self, keep) -> None:
        kept = set(keep)
        for e in [e for e in self._by_epoch if e not in kept]:
            del self._by_epoch[e]
        self._serving_by_epoch = {e: s for e, s in self._serving_by_epoch.items() if e in kept}
        self._layout_by_epoch = {e: lay for e, lay in self._layout_by_epoch.items() if e in kept}

    def epochs(self) -> list[int]:
        return list(self._by_epoch)

    def buffers(self, epoch: int) -> tuple:
        epoch = int(epoch)
        if epoch not in self._by_epoch:
            raise EpochError(f"epoch {epoch} is not in the routing table (have {self.epochs()})")
        return self._by_epoch[epoch]

    def layout(self, epoch: int) -> ShardLayout:
        """The ``ShardLayout`` a retained epoch was published under."""
        epoch = int(epoch)
        if epoch not in self._layout_by_epoch:
            raise EpochError(
                f"epoch {epoch} has no retained layout (have {sorted(self._layout_by_epoch)})")
        return self._layout_by_epoch[epoch]

    def shard_buffers(self, epoch: int) -> dict[int, tuple]:
        """shard id -> (device, block ids, block dists): views of the epoch's
        padded tensors."""
        ids_g, d_g = self.buffers(epoch)
        block = self.layout(epoch).block
        return {s: (ids_g.device, ids_g[s * block:(s + 1) * block],
                    d_g[s * block:(s + 1) * block]) for s in range(self.num_shards)}

    def serving(self, epoch: int):
        """The epoch's replica buffer pair, or None when it was published
        without a replication plan."""
        return self._serving_by_epoch.get(int(epoch))

    def replica_buffers(self, epoch: int) -> dict[int, tuple]:
        """slot id -> (shard, device, block ids, block dists) for a retained
        epoch with replicas: primaries are the padded tensors' blocks, replica
        slots the blocks of the epoch's replica buffers (empty without)."""
        serving = self.serving(epoch)
        if serving is None:
            return {}
        s_ids, s_d = serving
        block = self.layout(epoch).block
        out = {s: (s, *bufs) for s, bufs in self.shard_buffers(epoch).items()}
        for j in range(self.num_shards, len(self.slot_shard)):
            r = j - self.num_shards
            out[j] = (int(self.slot_shard[j]), s_ids.device, s_ids[r * block:(r + 1) * block],
                      s_d[r * block:(r + 1) * block])
        return out


class ShardedQueryEngine(EngineCore):
    """Row-sharded drop-in for ``QueryEngine`` on one card (see module doc)."""

    def __init__(
        self,
        ids,
        dists,
        k: int,
        objects,
        *,
        bn: BNGraph | None = None,
        shards: int | None = None,
        plan: PartitionPlan | None = None,
        device="cuda",
        use_kernel: bool = True,
    ):
        plan = PartitionPlan.resolve(plan, shards=shards)
        self.device = resolve_device(device)
        self.num_shards = 1 if plan.shards is None else int(plan.shards)
        self.n, ids, dists = EngineCore.normalize_tables(ids, dists, k, bn, self.device)
        starts = self._plan_starts(plan, objects=objects)
        self._init_layout(int(k), starts=starts)
        self._ids_g, self._d_g = shard_tables(ids, dists, self.n, self.num_shards, starts=starts)
        super().__init__(k, objects, bn=bn, use_kernel=use_kernel)
        self._apply_plan_replication(plan)

    def _plan_starts(self, plan: PartitionPlan, *, objects=None, saved=None):
        """A plan's ``ranges`` -> a boundary vector, or None for equal-width:
        explicit ranges as given; ``auto`` splits by object density; None
        reuses ``saved`` boundaries when they fit the shard count."""
        if isinstance(plan.ranges, tuple):
            starts = np.asarray(plan.ranges, np.int64)
            if len(starts) != self.num_shards:
                raise EngineConfigError(
                    f"plan names {len(starts)} range boundaries but the engine "
                    f"has {self.num_shards} shards")
            return starts
        if (saved is not None and len(saved) == self.num_shards
                and not ShardLayout.from_starts(self.n, saved).is_equal):
            return np.asarray(saved, np.int64)
        if plan.ranges == "auto" and objects is not None and len(objects):
            if self.num_shards == 1:
                return None
            w = np.full(self.n, 1e-3)
            w[np.asarray(objects, np.int64)] += 1.0
            return propose_starts(w, self.num_shards)
        return None

    def _apply_plan_replication(self, plan: PartitionPlan) -> None:
        rep = plan.replication_dict()
        if rep:
            self.set_replication(rep, policy=plan.policy)
        elif plan.policy != self.replica_policy:
            self.replica_policy = plan.policy

    def _init_layout(self, k: int, starts=None) -> None:
        """The host side of the layout (routing table, shard_rows, the vertex
        -> padded-row map) and the flush state. Needs ``num_shards`` and
        ``n``; the one source of the layout arithmetic for every constructor."""
        if not 1 <= self.num_shards <= max(self.n, 1):
            raise EngineConfigError(f"cannot split n={self.n} rows into {self.num_shards} shards")
        self.routing = ShardRoutingTable(self.n, self.num_shards, starts=starts)
        self.shard_rows = self.routing.shard_rows
        self._g_of_v = self.routing.padded_rows(np.arange(self.n, dtype=np.int64))
        self._tables_shared = True
        # repartition-on-flush: boundaries staged for the next flush
        self._pending_layout: ShardLayout | None = None
        self._partition_stats = {"repartitions": 0}
        # collective halo: the BNS adjacency in the CURRENT row layout (built
        # lazily, dropped on every layout change) and the per-round cap on the
        # padded per-owner served rows; a round past it takes the routed path
        self._nbr_glob_g: torch.Tensor | None = None
        self.halo_capacity = 4096
        self._halo_stats = {"halo_rounds_collective": 0, "halo_fallbacks": 0}
        # presence masks the collective frontier rounds leave for the next
        # round's receiver expansion; None = not armed (round one)
        self._fmask: list | None = None
        self._fmask_ok = True
        self.replica_policy = "round_robin"
        self.replica_fault_hook = None  # chaos seam: fn(engine) or None
        self._replicated = False
        self._rstats = {"replica_queries": 0, "replica_batches": 0, "replica_errors": 0}

    # ------------------------------------------------------------------
    # construction / conversion
    # ------------------------------------------------------------------

    @classmethod
    def build(
        cls,
        bn: BNGraph,
        objects: np.ndarray,
        k: int,
        *,
        shards: int | None = None,
        plan: PartitionPlan | None = None,
        device="cuda",
        use_kernel: bool = True,
    ) -> "ShardedQueryEngine":
        """Construct on the card (the two one-launch sweeps) and serve
        sharded: the sweeps' tables are re-laid into the padded layout by one
        gather on the card, with no host readback."""
        plan = PartitionPlan.resolve(plan, shards=shards)
        eng = cls.__new__(cls)  # skip __init__: the tables are born sharded
        eng.device = resolve_device(device)
        eng.num_shards = 1 if plan.shards is None else int(plan.shards)
        eng.n = bn.n
        starts = eng._plan_starts(plan, objects=objects)
        eng._init_layout(int(k), starts=starts)
        eng._ids_g, eng._d_g = build_knn_tables(
            bn, objects, k, device=eng.device, use_kernel=use_kernel,
            shards=eng.num_shards, starts=starts)
        EngineCore.__init__(eng, k, objects, bn=bn, use_kernel=use_kernel)
        eng._apply_plan_replication(plan)
        return eng

    @classmethod
    def from_index(
        cls, index: KNNIndex, objects, *, bn: BNGraph | None = None, shards: int | None = None,
        plan: PartitionPlan | None = None, device="cuda", use_kernel: bool = True,
    ) -> "ShardedQueryEngine":
        """Upload a host ``KNNIndex`` (an oracle-built one, say), sharded."""
        dists = np.where(index.ids >= 0, index.dists, np.inf).astype(np.float32)
        return cls(np.array(index.ids, np.int32), dists, index.k, objects, bn=bn, shards=shards,
                   plan=plan, device=device, use_kernel=use_kernel)

    @classmethod
    def load(
        cls,
        path,
        *,
        bn: BNGraph | None = None,
        shards: int | None = None,
        journal=None,
        replication: dict[int, int] | None = None,
        plan: PartitionPlan | None = None,
        device="cuda",
        use_kernel: bool = True,
    ) -> "ShardedQueryEngine":
        """Load a ``save`` artifact of either package into a sharded engine:
        reshard-on-load. The artifact stores the logical vertex-order tables,
        so the writer's shard count does not bind the reader: ``shards=None``
        takes the saved count (the JAX engine caps it at its visible devices;
        one card holds any number of logical shards), ``shards=M`` overrides.

        Saved uneven boundaries (``meta["starts"]``) are re-applied when the
        reader keeps the writer's shard count and the plan names no explicit
        ranges. A saved replication plan is re-applied at the writer's shard
        count and dropped otherwise; ``replication={...}`` installs another,
        ``{}`` drops it. ``journal`` attaches and replays a write-ahead
        journal exactly as ``QueryEngine.load`` does.
        """
        plan = PartitionPlan.resolve(plan, shards=shards, replication=replication)
        device = resolve_device(device)
        ids, dists, k, objects, meta = load_artifact(path)
        shards = plan.shards if plan.shards is not None else int(meta.get("shards", 1))
        ranges = plan.ranges
        if not isinstance(ranges, tuple):
            saved_starts = meta.get("starts")
            if saved_starts is not None and len(saved_starts) == shards:
                ranges = tuple(int(s) for s in saved_starts)
        eng = cls(ids, dists.astype(np.float32), k, objects, bn=bn, device=device,
                  use_kernel=use_kernel,
                  plan=dataclasses.replace(plan, shards=shards, ranges=ranges, replication=None))
        rep = plan.replication_dict()
        if rep is None and not plan.auto_replicas():
            saved = {int(s): int(r) for s, r in (meta.get("replication") or {}).items()}
            if saved and shards == int(meta.get("shards", 1)):
                rep = saved
        if rep:
            eng.set_replication(rep, policy=plan.policy)
        if journal is not None:
            eng.attach_journal(journal)
        return eng

    def to_index(self) -> KNNIndex:
        """Read the tables back into the host ``KNNIndex`` view (vertex order)."""
        ids, d = self.logical_tables()
        return tables_to_index(ids, d, self.n, self.k)

    @property
    def tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The live padded (S*(R+1), k) id/dist tensors. Between flushes they
        ARE the current epoch's tensors: read, do not write."""
        return self._ids_g, self._d_g

    def logical_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The (n, k) tables in vertex order, on the card."""
        rows = self._upload(self._g_of_v)
        return self._ids_g[rows], self._d_g[rows]

    # ------------------------------------------------------------------
    # epoch hooks (one atomic swap behind the routing table)
    # ------------------------------------------------------------------

    def _table_snapshot(self) -> tuple[torch.Tensor, torch.Tensor]:
        # from here on the working tensors are shared with readers: the next
        # flush clones them before its first write
        self._tables_shared = True
        return self._ids_g, self._d_g

    def _restore_tables(self, snap: tuple) -> None:
        self._ids_g, self._d_g = snap
        self._tables_shared = True
        # a flush that died inside a repartition, after the working layout
        # swapped, re-syncs to the published epoch's layout; the boundaries
        # stay staged, so a retry re-applies them
        lay = self.routing.layout(self.epoch)
        if not lay.same_as(self.routing.current_layout):
            self._apply_layout(lay)

    def _own_tables(self) -> None:
        """Copy-on-first-write: make the working tables private to the flush."""
        if self._tables_shared:
            self._ids_g = self._ids_g.clone()
            self._d_g = self._d_g.clone()
            self._tables_shared = False

    def _publish_epoch(self, epoch: int) -> None:
        # one step: the EpochStore swap, the routing table's epoch -> buffers
        # entry, the epoch's layout and (under a plan) its replica buffers
        super()._publish_epoch(epoch)
        buffers = self._epochs.snapshot(epoch)
        serving = self._build_serving(*buffers) if self._replicated else None
        self.routing.publish(epoch, buffers, keep=self._epochs.epochs(), serving=serving)
        self._pending_layout = None  # a staged repartition is now live

    def _trim_epoch_stats(self) -> None:
        super()._trim_epoch_stats()
        self.routing.trim(self._epochs.epochs())

    def _table_bytes(self) -> int:
        # the padded layout pays for its pad rows: count them
        return self.num_shards * (self.shard_rows + 1) * self.k * 8

    # ------------------------------------------------------------------
    # repartition-on-flush
    # ------------------------------------------------------------------

    def stage_repartition(self, starts) -> None:
        """Stage new shard-range boundaries for the next flush (one entry a
        shard, first 0, strictly increasing: ``propose_starts`` over a query
        histogram, say). The flush re-lays the working tables under them and
        publishes tables and layout in one epoch; a flush that fails rolls
        back to the old boundaries with the repartition still staged."""
        lay = ShardLayout.from_starts(self.n, starts)
        if lay.num_shards != self.num_shards:
            raise EngineConfigError(
                f"boundary vector names {lay.num_shards} shards, engine has {self.num_shards}")
        self._pending_layout = lay

    def repartition(self, starts) -> dict:
        """``stage_repartition`` + ``flush_updates``; returns the flush stats
        (staged object updates ride the same epoch)."""
        self.stage_repartition(starts)
        return self.flush_updates()

    @property
    def pending_repartition(self) -> np.ndarray | None:
        """The staged boundary vector, or None."""
        lay = self._pending_layout
        return None if lay is None else lay.starts.copy()

    def _prepare_publish(self) -> None:
        """Re-lay the working tables under the staged boundaries: one gather
        on the card through the new-layout -> old-layout row map into new
        tensors, then the host-side layout swap. Fires the
        ``pre-repartition`` and ``mid-repartition`` checkpoints; a failure
        rolls back through ``_restore_tables``."""
        lay = self._pending_layout
        if lay is None:
            return
        old = self.routing.current_layout
        if old.same_as(lay):
            self._pending_layout = None
            return
        self._checkpoint("pre-repartition")
        # old-layout source row per new-layout row; pad rows read the old
        # address of the dummy vertex n (a pad sentinel row)
        pad_row = int(old.padded_rows(np.array([self.n], np.int64))[0])
        src = np.full(self.num_shards * lay.block, pad_row, np.int64)
        v = np.arange(self.n, dtype=np.int64)
        src[lay.padded_rows(v)] = old.padded_rows(v)
        src_t = self._upload(src)
        new_ids, new_d = self._ids_g[src_t], self._d_g[src_t]
        self._checkpoint("mid-repartition")
        self._ids_g, self._d_g = new_ids, new_d
        self._tables_shared = False
        self._apply_layout(lay)
        self._partition_stats["repartitions"] += 1

    def _apply_layout(self, lay: ShardLayout) -> None:
        """Swap the CURRENT layout: routing boundaries and the vertex ->
        padded-row map; the layout-bound adjacency is dropped (rebuilt lazily
        under the new map). Published epochs keep their own layouts."""
        self.routing.set_layout(lay)
        self.shard_rows = lay.shard_rows
        self._g_of_v = lay.padded_rows(np.arange(self.n, dtype=np.int64))
        self._nbr_glob_g = None

    def partition_plan(self) -> PartitionPlan:
        """The active layout as a ``PartitionPlan`` (stats, introspection)."""
        lay = self.routing.current_layout
        rep = tuple(sorted(self.routing.replication.items()))
        return PartitionPlan(
            shards=self.num_shards,
            ranges=None if lay.is_equal else tuple(int(s) for s in lay.starts),
            replication=rep or None,
            policy=self.replica_policy,
        )

    # ------------------------------------------------------------------
    # replicated hot shards: flushes write only the primary layout; each
    # _publish_epoch copies the replicated shards' fresh blocks into the
    # epoch's replica buffer
    # ------------------------------------------------------------------

    def set_replication(self, plan: dict[int, int] | None, *, policy: str | None = None) -> None:
        """Install (or with ``None`` / ``{}`` drop) a shard -> extra-replica
        plan and re-publish every retained epoch's replica buffers, so pinned
        reads on any retained epoch are served from replicas too."""
        if policy is not None:
            if policy not in ROUTE_POLICIES:
                raise EngineConfigError(f"unknown replica routing policy {policy!r}")
            self.replica_policy = policy
        plan = {int(s): int(r) for s, r in (plan or {}).items() if int(r) > 0}
        if not plan:
            self.routing.set_replication({})
            self._replicated = False
            for e in self.routing.epochs():
                self.routing.publish(e, self.routing.buffers(e), serving=None)
            return
        self.routing.set_replication(plan)
        self._replicated = True
        for e in self.routing.epochs():
            buffers = self.routing.buffers(e)
            self.routing.publish(e, buffers, serving=self._build_serving(*buffers))

    def _build_serving(self, ids_g: torch.Tensor, d_g: torch.Tensor):
        """An epoch's replica buffers: slot ``S + r``'s copy of its shard's
        block at rows ``[r*(R+1), (r+1)*(R+1))``, one copy on the card a
        replica slot. The block size is read off the tensors, so re-publishing
        an epoch from before a repartition copies under ITS layout."""
        block = ids_g.shape[0] // self.num_shards
        shards = self.routing.slot_shard[self.num_shards:]
        rows = (shards[:, None] * block + np.arange(block)[None, :]).reshape(-1)
        rows_t = self._upload(rows)
        return ids_g[rows_t], d_g[rows_t]

    # ------------------------------------------------------------------
    # queries: owner routing and one gather, both on the card (the replica
    # fan-out picks its slots on the host, as the routing policies are host
    # state)
    # ------------------------------------------------------------------

    def _route(self, us: np.ndarray, layout: ShardLayout | None = None):
        """(padded rows, owner shards) of a batch of ids under ``layout``
        (default the CURRENT boundaries; a pinned read on an epoch published
        before a repartition passes that epoch's layout), with the scalar
        gather's index semantics for any id: a negative id wraps once from the
        end of the (n+1)-row table (-1 is the dummy row), then everything
        clamps into [0, n]; n reads its owner's dummy row (-1, +inf)."""
        if layout is None:
            layout = self.routing.current_layout
        vs = np.asarray(us, np.int64)
        vs = np.clip(np.where(vs < 0, vs + self.n + 1, vs), 0, self.n)
        own = layout.owner(vs)
        rows = np.where(vs >= self.n, own * layout.block + layout.block - 1,
                        layout.padded_rows(vs, own))
        return rows, own

    def _route_on_card(self, us: np.ndarray, layout: ShardLayout) -> torch.Tensor:
        """``_route``'s rows of a query batch, computed on the card: the batch
        goes up as it came, the owner search (``searchsorted`` against the
        start boundaries) runs there."""
        n, block = self.n, layout.block
        vs = self._upload(np.asarray(us)).long()
        vs = torch.where(vs < 0, vs + n + 1, vs).clamp_(0, n)
        starts = self._upload(layout.starts)
        own = (torch.searchsorted(starts, vs, right=True) - 1).clamp_(max=self.num_shards - 1)
        rows = own * block + (vs - starts[own])
        return torch.where(vs >= n, own * block + block - 1, rows)

    def _gather_batch(self, us: np.ndarray, ks: np.ndarray, snap: tuple, epoch: int):
        # the epoch's OWN layout: a pinned read on an epoch published before a
        # repartition routes by the boundaries it was published with
        layout = self.routing.layout(epoch)
        serving = self.routing.serving(epoch)
        ks_t = self._upload(ks)
        if serving is not None and self._replicated:
            try:
                return self._gather_replicated(us, ks_t, snap, serving, layout)
            except QueryError:
                raise  # routing misuse, not a replica fault
            except Exception as e:  # noqa: BLE001 (degrade, don't die)
                if sanitize.is_sync_error(e):
                    raise  # a sync under the guard is a code fault, not a replica's
                self._rstats["replica_errors"] += 1
                self._rstats["last_replica_error"] = f"{type(e).__name__}: {e}"
        return ops.serve_gather(snap[0], snap[1], self._route_on_card(us, layout), ks_t)

    def _gather_replicated(self, us: np.ndarray, ks: torch.Tensor, snap: tuple, serving: tuple,
                           layout: ShardLayout):
        """The replica fan-out: each query goes to a slot of its owner shard
        under the routing policy; primary slots read the epoch's padded
        tensors, replica slots the epoch's replica buffers."""
        if self.replica_fault_hook is not None:
            self.replica_fault_hook(self)  # chaos seam: a simulated replica loss
        rows, own = self._route(us, layout)
        slots = self.routing.assign_slots(own, self.replica_policy)
        # every slot of a shard holds a copy of its block: move the row from
        # the owner's block to the slot's (replica slot r at block r - S of the
        # replica buffer)
        rows += (slots - own) * layout.block
        rep = slots >= self.num_shards
        rows[rep] -= self.num_shards * layout.block
        self.routing.record_dispatch(slots)
        try:
            ids = torch.empty((len(rows), self.k), dtype=torch.int32, device=self.device)
            d = torch.empty((len(rows), self.k), dtype=torch.float32, device=self.device)
            for where, (t_ids, t_d) in ((~rep, snap), (rep, serving)):
                at = self._upload(np.flatnonzero(where))
                ids[at], d[at] = ops.serve_gather(t_ids, t_d, self._upload(rows[where]), ks[at])
        finally:
            self.routing.record_complete(slots)
        self._rstats["replica_batches"] += 1
        self._rstats["replica_queries"] += int(np.sum(rep))
        return ids, d

    # ------------------------------------------------------------------
    # flush hooks
    # ------------------------------------------------------------------

    def _group_by_owner(self, owner: np.ndarray, groups: int | None = None):
        """Stable group-by-owner of a batch: (input order permutation, owner per
        sorted entry, slot within the owner's group, largest group)."""
        if groups is None:
            groups = self.num_shards
        # a stable sort of small integers: the narrowest type sorts by radix
        order = np.argsort(owner.astype(np.min_scalar_type(groups)), kind="stable")
        counts = np.bincount(owner, minlength=groups)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        o_sorted = owner[order]
        slot = np.arange(len(owner)) - starts[o_sorted]
        return order, o_sorted, slot, int(counts.max()) if len(owner) else 1

    def _del_tensor(self, deletes: list[int]) -> torch.Tensor:
        # an empty delete list still needs one id to test against: n is never
        # an object id, so never a hit
        return self._upload(np.asarray(deletes if deletes else [self.n], np.int32))

    def _scan_delete_rows(self, deletes: list[int]) -> np.ndarray:
        # (S, R) hit masks: row j of shard s is vertex starts[s] + j while
        # j < widths[s] (rows past a shard's width are all-pad, never hit)
        lay = self.routing.current_layout
        hits = ops.shard_rows_containing(self._ids_g, self._del_tensor(deletes), lay.block)
        s_idx, j_idx = np.nonzero(self._readback(hits))
        valid = j_idx < lay.widths[s_idx]
        return (lay.starts[s_idx] + j_idx)[valid].astype(np.int32)

    def _table_kth(self) -> np.ndarray:
        kth = self._readback(self._d_g[:, -1])
        return kth[self._g_of_v].astype(np.float64)

    def _host_tables(self) -> tuple[np.ndarray, np.ndarray]:
        # always the logical vertex-order (n, k) layout: shard padding is a
        # runtime concern, not an artifact one (reshard-on-load)
        ids, d = self.logical_tables()
        return self._readback(ids), self._readback(d)

    def _apply_rows(self, rows: np.ndarray, deletes: list[int], cand_ids, cand_d) -> np.ndarray:
        """Group a row batch by owner shard and run every shard's fused
        purge+merge in one call (one K1 launch); returns the per-row changed
        mask in input order. The (P, C) candidates (numpy arrays or tensors)
        go to the card once; the grouping into (S, rmax, C) is a gather there."""
        s = self.num_shards
        order, o_sorted, slot, rmax = self._group_by_owner(self.routing.owner(rows))
        rglob = np.full((s, rmax), -1, np.int32)
        rglob[o_sorted, slot] = self.routing.padded_rows(rows[order], o_sorted)
        src = np.full((s, rmax), len(rows), np.int64)  # a pad slot reads the pad row
        src[o_sorted, slot] = order
        cand_ids, cand_d = (x if isinstance(x, torch.Tensor) else self._upload(x)
                            for x in (cand_ids, cand_d))
        src_t = self._upload(src)
        ci = torch.cat([cand_ids, torch.full_like(cand_ids[:1], -1)])[src_t]
        cd = torch.cat([cand_d, torch.full_like(cand_d[:1], _INF)])[src_t]
        self._own_tables()
        changed = self._readback(ops.shard_rows_purge_merge(
            self._ids_g, self._d_g, self._upload(rglob), self.shard_rows + 1,
            self._del_tensor(deletes), ci, cd, self.k, use_kernel=self.use_kernel))
        out = np.zeros(len(rows), dtype=bool)
        out[order] = changed[o_sorted, slot]
        return out

    def _purge_merge(self, rows, deletes, cand_ids, cand_d) -> None:
        self._apply_rows(rows, deletes, cand_ids, cand_d)

    # ------------------------------------------------------------------
    # the flush's round loops (module doc, Execution)
    # ------------------------------------------------------------------

    def _parts(self, rows: np.ndarray) -> list:
        return bucket_parts(self._nbr_deg, self._bucket_widths(), rows)

    def _repair(self, rows: np.ndarray) -> int:
        """Jacobi repair rounds over the purged rows; returns the round count.

        Round 1 re-merges every purged row; later rounds only the frontier:
        a row can improve again only if a BNS neighbour's row changed last
        round (BN adjacency is symmetric, so BNS(changed) IS that set). Only
        the frontier's *vertex ids* survive a round boundary; the row data
        never leaves the card between rounds.
        """
        self._nbr_tables()
        collective = self.num_shards > 1 and self.halo == "collective"
        active = rows
        rounds = 0
        while active.size and rounds < _MAX_REPAIR_ROUNDS:
            changed = [part[self._repair_part(part, t)] for t, part in self._parts(active)]
            rounds += 1
            self._checkpoint("mid-repair-round")
            changed = np.concatenate(changed) if changed else np.empty(0, np.int32)
            if changed.size == 0:
                break
            if collective:
                nbrs = self._expand_receivers_device(changed)
                active = np.intersect1d(nbrs, rows).astype(np.int32)
            else:
                active = repair_receivers(self.bn.lo_ids, self.bn.hi_ids, changed, rows)
        else:
            if active.size:
                raise RuntimeError(
                    f"delete repair did not reach a fixpoint in {_MAX_REPAIR_ROUNDS} rounds"
                )
        return rounds

    def _insert_frontier(
        self, inserts: list[int]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """The batched checkIns frontier (``EngineCore``'s contract): round
        r relaxes the BNS edges of every vertex whose tentative distance
        changed in round r-1 (round 1: the sources themselves), pruned on the
        card by the live k-th-distance column. The changed rows of each
        round come back and make the next receiver set; after convergence
        the touched rows' (R, B) affected mask and distances come back and
        are compacted on the host (``compact_candidates``)."""
        self._nbr_tables()
        src = np.asarray(inserts, np.int32)
        state = self._frontier_init(src)
        active = np.unique(src)
        touched = [active]
        rounds = 0
        while active.size and rounds < _MAX_REPAIR_ROUNDS:
            changed = self._frontier_round(state, self._frontier_receivers(active))
            rounds += 1
            active = np.concatenate(changed) if changed else np.empty(0, np.int32)
            if active.size:
                touched.append(active)
        if active.size:
            raise RuntimeError(
                f"checkIns frontier did not reach a fixpoint in {_MAX_REPAIR_ROUNDS} rounds"
            )
        rows = np.unique(np.concatenate(touched)).astype(np.int32)
        trace.count("rows_touched", rows.size)
        aff, dvals = self._frontier_extract(state, rows, src)
        return (*compact_candidates(rows, aff, dvals, src), rounds)

    def _repair_part(self, part: np.ndarray, t: int) -> np.ndarray:
        """One Jacobi re-merge of ``part``, rows of width bucket ``t``,
        against their bridge neighbourhoods. At one shard every neighbour
        row is local and the padded tensor IS the scalar (n+1, k) layout, so
        the round is the scalar engine's (K2). At S > 1 the halo runs per
        ``self.halo``: the collective round (a round past ``halo_capacity``
        falls back) or the routed host round. The candidate multisets are
        the scalar round's either way."""
        if self.num_shards == 1:
            self._own_tables()
            nbr_tab, w_tab = self._nbr_slice(t)
            return self._readback(_repair_round(nbr_tab, w_tab, self._upload(part), self._ids_g,
                                                self._d_g, self.use_kernel))
        if self.halo == "collective":
            out = self._repair_part_collective(part, t)
            if out is not None:
                return out
            self._halo_stats["halo_fallbacks"] += 1
        return self._repair_part_host(part, t)

    def _fetch_rows(self, vs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Routed raw-row fetch to the host (the host halo's exchange)."""
        rows = self._upload(self._route(vs)[0])
        return self._readback(self._ids_g[rows]), self._readback(self._d_g[rows])

    def _routed_plan(self, part: np.ndarray, t: int):
        """The host halo's set algebra for one round over ``part`` at width
        ``t``: the unique neighbours, each neighbour's row in the fetched
        slab (``len(uniq)`` = miss) and the edge weights."""
        nbr = self._nbr_ids[part, :t]
        valid = nbr >= 0
        uniq, inv = unique_inverse(nbr[valid], self.n)
        slot = np.full(nbr.shape, len(uniq), dtype=np.int32)
        slot[valid] = inv
        return uniq, self._upload(slot), self._upload(self._nbr_w[part, :t])

    def _repair_part_host(self, part: np.ndarray, t: int) -> np.ndarray:
        """Routed-gather repair round: the unique neighbour rows go through the
        host (fetched, then sent back up as the receivers' slab), the shifted
        candidate lists are built from the slab, every shard merges (K1)."""
        uniq, slot, w = self._routed_plan(part, t)
        f_ids, f_d = (self._upload(x) for x in self._fetch_rows(uniq))
        cand_ids, cand_d = ops.halo_candidates(f_ids, f_d, slot, w, self.k)
        return self._apply_rows(part, [], cand_ids, cand_d)

    def _repair_part_collective(self, part: np.ndarray, t: int) -> np.ndarray | None:
        """Collective repair round: owners serve the round's unique neighbour
        rows into one slab (gathered before any merge: Jacobi reads), every
        receiver builds its candidates from the slab, one K1 launch merges
        every shard. None when the round's halo exceeds ``halo_capacity``."""
        plan = self._halo_plan(part, self._nbr_ids[part, :t], self._nbr_w[part, :t])
        if plan is None:
            return None
        serve, slotm, wm, rglob, order, o_sorted, slot = plan
        s, rmax = rglob.shape
        block = self.shard_rows + 1
        self._own_tables()
        recv_ids, recv_d = (all_gather_served(x) for x in ops.shard_gather_rows(
            self._ids_g, self._d_g, self._upload(serve), block))
        ci, cd = ops.halo_candidates(recv_ids, recv_d, self._upload(slotm.reshape(s * rmax, t)),
                                     self._upload(wm.reshape(s * rmax, t)), self.k)
        changed = self._readback(ops.shard_rows_purge_merge(
            self._ids_g, self._d_g, self._upload(rglob), block, self._del_tensor([]),
            ci.reshape(s, rmax, -1), cd.reshape(s, rmax, -1), self.k,
            use_kernel=self.use_kernel))
        self._halo_stats["halo_rounds_collective"] += 1
        out = np.zeros(len(part), dtype=bool)
        out[order] = changed[o_sorted, slot]
        return out

    def _halo_plan(self, part: np.ndarray, nbr: np.ndarray, w: np.ndarray):
        """Index bookkeeping for one collective halo round (repair or
        frontier): which unique neighbour rows each owner serves, and where
        each receiver finds its neighbours in the receive slab.

        Returns ``(serve, slotm, wm, rglob, order, o_sorted, slot)``, or None
        when the padded per-owner served-row count exceeds ``halo_capacity``:

        - ``serve`` (S, Umax): padded rows shard *src* serves (-1 pads), every
          unique neighbour of ``part`` once, in its owner's part;
        - ``slotm`` (S, rmax, t): each neighbour's row in the (S*Umax) slab
          (S*Umax = miss, which the candidate and fold ops read as a pad);
        - ``wm`` (S, rmax, t) edge weights and ``rglob`` (S, rmax) receiver
          rows (-1 pads), grouped by owner;
        - ``order/o_sorted/slot``: the grouping that maps the (S, rmax)
          changed mask back to ``part`` order.

        Umax is padded to a power of two (>= 16), as the JAX engine pads it:
        the capacity test, and so ``halo_fallbacks``, are the JAX engine's.
        Every row map goes through the CURRENT ``ShardLayout``.
        """
        lay = self.routing.current_layout
        s = self.num_shards
        t = nbr.shape[1]
        valid = nbr >= 0
        uniq, inv = unique_inverse(nbr[valid], self.n)
        own_u = lay.owner(uniq)
        order_u, src_sorted, within, umax = self._group_by_owner(own_u)
        umax = _pow2_pad(umax, lo=16)
        if umax > self.halo_capacity:
            return None
        serve = np.full((s, umax), -1, np.int32)
        serve[src_sorted, within] = lay.padded_rows(uniq[order_u], src_sorted)
        pos = np.empty(len(uniq), np.int64)
        pos[order_u] = src_sorted * umax + within
        sm = np.full(nbr.shape, s * umax, np.int64)
        sm[valid] = pos[inv]
        order, o_sorted, slot, rmax = self._group_by_owner(lay.owner(part))
        slotm = np.full((s, rmax, t), s * umax, np.int32)
        wm = np.zeros((s, rmax, t), np.float32)
        rglob = np.full((s, rmax), -1, np.int32)
        slotm[o_sorted, slot] = sm[order]
        wm[o_sorted, slot] = w[order]
        rglob[o_sorted, slot] = lay.padded_rows(part[order], o_sorted)
        return serve, slotm, wm, rglob, order, o_sorted, slot

    def _nbr_glob(self) -> torch.Tensor:
        """The (S*(R+1), cap) BNS adjacency in the CURRENT row layout (vertex
        v's neighbour ids at row ``_g_of_v[v]``, all -1 on pad rows), built
        lazily and dropped by ``_apply_layout``."""
        if self._nbr_glob_g is None:
            self._nbr_tables()
            rows = self.num_shards * (self.shard_rows + 1)
            self._nbr_glob_g = self._upload(self.bn.bns_packed().relayout_rows(rows, self._g_of_v))
        return self._nbr_glob_g

    def _presence(self, rows: torch.Tensor, shard: torch.Tensor, width: int,
                  keep: torch.Tensor | None = None) -> torch.Tensor:
        """Each shard's presence mask of the neighbours (first ``width``
        columns of the adjacency) of its ``rows`` (where ``keep``), summed over
        the shards: a (size+1,) count, the last slot absorbing -1 pads."""
        size = self.num_shards * (self.shard_rows + 1)
        nb = self._nbr_glob()[rows][:, :width].long()
        if keep is not None:
            nb = torch.where(keep[:, None], nb, -1)
        idx = torch.where(nb < 0, size, nb)
        masks = torch.zeros((self.num_shards, size + 1), dtype=torch.int32, device=self.device)
        # a device scalar: a Python one would go up with a blocking copy
        masks[shard[:, None].expand_as(idx), idx] = torch.ones((), dtype=masks.dtype,
                                                               device=self.device)
        return psum_masks(masks)

    def _frontier_receivers(self, active: np.ndarray) -> np.ndarray:
        """The next frontier round's receiver set, sorted: the BNS
        neighbours of the ``active`` (changed) vertices, by
        ``expand_receivers`` on the host, or in the collective halo mode
        marked on the card."""
        if self.num_shards == 1 or self.halo != "collective":
            return expand_receivers(self._nbr_indptr, self._nbr_indices, active)
        # if the previous frontier round ran fully collective, its rounds
        # already left this round's presence masks (neighbours of exactly
        # the changed = active rows): read those
        masks, ok = self._fmask, self._fmask_ok
        self._fmask, self._fmask_ok = [], True  # armed for the coming round
        if masks and ok:
            m = self._readback(torch.stack(masks).sum(dim=0))
            return np.flatnonzero(m[:-1]).astype(np.int32)
        return self._expand_receivers_device(active)

    def _expand_receivers_device(self, active: np.ndarray) -> np.ndarray:
        """Receiver-set expansion on the card: route the active vertices to
        their owners, mark their neighbours in each shard's presence mask, sum
        the masks and read back the ascending nonzero slots: exactly
        ``expand_receivers``."""
        active = np.asarray(active, np.int64)
        own = self.routing.owner(active)
        mask = self._presence(self._upload(self.routing.padded_rows(active, own)),
                              self._upload(own), self._nbr_ids.shape[1])
        return np.flatnonzero(self._readback(mask)[:-1]).astype(np.int32)

    # ------------------------------------------------------------------
    # frontier provider: the (S*(R+1), B) tentative-distance state is laid
    # out like the tables; the owner gates its rows by its own k-th column
    # (checkIns) before they are exchanged
    # ------------------------------------------------------------------

    def _frontier_init(self, src: np.ndarray) -> torch.Tensor:
        self._fmask, self._fmask_ok = None, True  # round one expands standalone
        # source columns padded to a multiple of 4 (-1 pads, +inf throughout),
        # as the scalar engine pads them for K3
        b = -(-len(src) // _FRONTIER_COLS) * _FRONTIER_COLS
        srcp = np.pad(np.asarray(src, np.int32), (0, b - len(src)), constant_values=-1)
        self._fsrc = self._upload(srcp)  # vertex ids (the one-shard scalar path)
        grow = np.full(srcp.shape, -1, np.int64)
        m = srcp >= 0
        grow[m] = self._g_of_v[srcp[m]]
        self._fsrc_g = self._upload(grow.astype(np.int32))
        self._fkth = self._d_g[:, -1].contiguous()
        if self.num_shards == 1:
            return _frontier_init_prog(self._fsrc, self._ids_g.shape[0])
        # 0 at (source row, column); padded columns park their +inf on shard
        # 0's dummy row
        real = self._fsrc_g >= 0
        dist = torch.full((self._ids_g.shape[0], b), _INF, dtype=torch.float32,
                          device=self.device)
        dist[torch.where(real, self._fsrc_g, self.shard_rows).long(),
             torch.arange(b, device=self.device)] = torch.where(real, 0.0, _INF)
        return dist

    def _frontier_round(self, state, nbrs: np.ndarray) -> list[np.ndarray]:
        """One frontier round over receiver set ``nbrs``, in place on
        ``state``: each ``bucket_parts`` part in turn; returns each part's
        changed rows. The changed masks are read back once the whole round
        is queued (a mask is a device tensor until then, so the later parts'
        upload work overlaps the earlier parts' compute). In the collective
        halo mode a round that overflows ``halo_capacity`` as a whole re-runs
        part by part (each part retries the collective round, then the
        routed one), and the next round's expansion runs standalone."""
        parts = self._parts(nbrs)
        if self.num_shards > 1 and self.halo == "collective":
            changed = self._frontier_round_collective(state, parts)
            if changed is not None:
                return changed
            self._halo_stats["halo_fallbacks"] += 1
            self._fmask_ok = False
        masks = [(part, self._frontier_part(state, part, t)) for t, part in parts]
        return [part[m if isinstance(m, np.ndarray) else self._readback(m)] for part, m in masks]

    def _frontier_part(self, state, part: np.ndarray, t: int):
        """One frontier round over ``part``, rows of width bucket ``t``, in
        place on ``state``; returns the changed mask. At one shard, the
        scalar engine's round (K3). At S > 1, per ``self.halo``: the
        collective round (a round past ``halo_capacity`` falls back) or the
        routed host round; the candidate values are the scalar round's
        either way, so the distance trajectories are bit-identical."""
        if self.num_shards == 1:
            nbr_tab, w_tab = self._nbr_slice(t)
            return _frontier_round(nbr_tab, w_tab, self._upload(part), state, self._fkth,
                                   self._fsrc, self.use_kernel)
        if self.halo == "collective":
            changed = self._frontier_part_collective(state, part, t)
            if changed is not None:
                return changed
            self._halo_stats["halo_fallbacks"] += 1
        # a routed part leaves no presence mask, so the round's expansion
        # runs standalone
        self._fmask_ok = False
        return self._frontier_part_host(state, part, t)

    def _fhalo(self, state: torch.Tensor, plan) -> tuple[torch.Tensor, torch.Tensor]:
        """One collective frontier round over one bucket, in place on
        ``state``: the owners gate their served rows by their own k-th column
        (the checkIns test; the column never leaves its shard), the gated rows
        are exchanged into one slab, and the receivers min-fold and
        min-update. Returns the (S, rmax) changed mask and the next round's
        presence mask of the changed receivers' neighbours."""
        serve, slotm, wm, rglob = plan[:4]
        s, rmax, t = slotm.shape
        block = self.shard_rows + 1
        sv = self._upload(serve)
        srows = ops.shard_rows(block, sv)                 # (S, U) rows of the tensor
        own = state[srows]                                # (S, U, B)
        gate = (own < self._fkth[srows][..., None]) | (sv[..., None] == self._fsrc_g)
        recv = all_gather_served(torch.where(gate, own, _INF))
        cand = ops.halo_fold_min(recv, self._upload(slotm.reshape(s * rmax, t)),
                                 self._upload(wm.reshape(s * rmax, t)))
        lr = ops.shard_rows(block, self._upload(rglob)).reshape(-1)
        ownr = state[lr]
        new = torch.minimum(ownr, cand)
        ch = (new < ownr).any(dim=1)
        state[lr] = new
        shard = torch.arange(s, device=self.device).repeat_interleave(rmax)
        return ch.reshape(s, rmax), self._presence(lr, shard, t, keep=ch)

    def _changed_in_order(self, changed: torch.Tensor, part: np.ndarray, plan) -> np.ndarray:
        order, o_sorted, slot = plan[4:]
        out = np.zeros(len(part), dtype=bool)
        out[order] = self._readback(changed)[o_sorted, slot]
        return out

    def _frontier_part_collective(self, state, part: np.ndarray, t: int) -> np.ndarray | None:
        plan = self._halo_plan(part, self._nbr_ids[part, :t], self._nbr_w[part, :t])
        if plan is None:
            return None
        changed, nmask = self._fhalo(state, plan)
        if self._fmask is not None:
            self._fmask.append(nmask)
        self._halo_stats["halo_rounds_collective"] += 1
        return self._changed_in_order(changed, part, plan)

    def _frontier_round_collective(self, state, parts: list) -> list[np.ndarray] | None:
        """A whole collective frontier round over ``bucket_parts``' parts:
        every part's plan first (None when any overflows ``halo_capacity``),
        then each part's collective round in order, the state threading part
        to part: the per-part schedule of the scalar and routed paths, so the
        round trajectories match theirs, not only the fixpoint. Returns each
        part's changed rows."""
        plans = []
        for t, part in parts:
            plan = self._halo_plan(part, self._nbr_ids[part, :t], self._nbr_w[part, :t])
            if plan is None:
                return None
            plans.append(plan)
        changed_parts = []
        for (_, part), plan in zip(parts, plans):
            changed, nmask = self._fhalo(state, plan)
            if self._fmask is not None:
                self._fmask.append(nmask)
            changed_parts.append(part[self._changed_in_order(changed, part, plan)])
        self._halo_stats["halo_rounds_collective"] += len(parts)
        return changed_parts

    def _frontier_part_host(self, state, part: np.ndarray, t: int) -> torch.Tensor:
        """Routed-gather frontier round: the gated neighbour send rows go
        through the host (the owner gates before its rows leave the shard;
        fetched, then sent back up as the receivers' slab), the receivers fold
        weight + min over their neighbours and min-update."""
        uniq, slot, w = self._routed_plan(part, t)
        send = self._upload(self._fetch_send(state, uniq))
        return self._apply_fmin(state, part, ops.halo_fold_min(send, slot, w))

    def _fetch_send(self, state, vs: np.ndarray) -> np.ndarray:
        """Routed gated-row fetch to the host (the host frontier's exchange):
        a (U, B) float32 array."""
        rows = self._upload(self._route(vs)[0])
        own = state[rows]
        gate = (own < self._fkth[rows][:, None]) | (rows[:, None] == self._fsrc_g.long()[None, :])
        return self._readback(torch.where(gate, own, _INF))

    def _apply_fmin(self, state, rows: np.ndarray, vals: torch.Tensor) -> torch.Tensor:
        """Min-update of the receivers' rows, in place on ``state``; returns
        the per-row changed mask as a bool tensor on the device, in ``rows``
        order."""
        g = self._upload(self.routing.padded_rows(rows))
        own = state[g]
        new = torch.minimum(own, vals)
        changed = (new < own).any(dim=1)
        state[g] = new
        return changed

    def _frontier_extract(self, state, rows: np.ndarray, src: np.ndarray):
        b = len(src)
        if self.num_shards == 1:
            aff, d = _frontier_affected(self._upload(rows), state, self._fkth, self._fsrc)
            return self._readback(aff[:, :b]), self._readback(d[:, :b])
        g = self._upload(self.routing.padded_rows(rows))
        dd = state[g]
        aff = (dd < self._fkth[g][:, None]) | (g[:, None] == self._fsrc_g.long()[None, :])
        return self._readback(aff[:, :b]), self._readback(dd[:, :b])

    # ------------------------------------------------------------------
    # persistence / stats
    # ------------------------------------------------------------------

    def _save_meta(self) -> dict:
        meta = {"shards": self.num_shards, "shard_rows": self.shard_rows}
        lay = self.routing.current_layout
        if not lay.is_equal:
            # uneven boundaries persist with the artifact; load re-applies
            # them when the reader keeps the writer's shard count
            meta["starts"] = [int(s) for s in lay.starts]
        if self.routing.replication:
            # keyed by shard id: only a reader at the same shard count reuses it
            meta["replication"] = {str(s): r for s, r in self.routing.replication.items()}
        return meta

    def _extra_stats(self) -> dict:
        padded = self.num_shards * (self.shard_rows + 1)
        lay = self.routing.current_layout
        return {
            "num_shards": self.num_shards,
            "shard_rows": self.shard_rows,
            "padded_rows": padded,
            "row_padding_overhead": round((padded - self.n) / max(self.n, 1), 4),
            "shard_starts": [int(s) for s in lay.starts],
            "range_rows": [int(w) for w in lay.widths],
            "uneven_ranges": not lay.is_equal,
            "repartitions": self._partition_stats["repartitions"],
            "halo": self.halo,
            **self._halo_stats,
            "replication": dict(self.routing.replication),
            "replica_slots": self.routing.num_slots,
            "replica_policy": self.replica_policy,
            **self._rstats,
        }
