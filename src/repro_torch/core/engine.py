"""Device-resident batched kNN serving engine, the production query surface.

``KNNIndex`` (core/index.py) is the paper's host view: one numpy row scan per
query, one heap loop per update. ``QueryEngine`` keeps the index as live device
``(n+1, k)`` id/dist tensors (the construction sweeps' layout, dummy row last)
and exposes the paper's three operations in batched form:

* ``query_batch(us, k)``: one row gather + per-query k mask for a whole batch
  of queries (Theorem 4.3's O(k) scan, vectorized); and
  ``query_progressive_batch``, which yields the first-i prefix incrementally
  (Theorem 4.4) from a single gather.

* staged updates: ``stage_insert`` / ``stage_delete`` / ``stage_move``
  accumulate object updates in an arrival-order queue; ``flush_updates``
  coalesces the queue to its net object-set delta and applies it as ONE fused
  device batch against the tables.

  Coalescing semantics (per object, in queue order): an insert followed by a
  delete of the same object cancels to nothing; a delete followed by an
  insert of the same object is a no-op (the index is a pure function of the
  final object set, Theorems 6.2/6.4); move chains collapse to their endpoint
  (``a->b`` then ``b->c`` is ``a->c``; a chain returning to its origin
  cancels). The per-flush stats dict reports the pure insert/delete counts,
  the net move count, and ``coalesced``, how many staged ops the folding
  eliminated.

  Application is a single fused pipeline: one device scan finds every row
  naming a deleted object (``ops.rows_containing``); the checkIns frontier for
  ALL staged inserts runs as multi-source pruned-relaxation rounds on device
  (``ops.frontier_relax`` with changed-frontier narrowing, see
  ``EngineCore._insert_frontier``; the host ``updates.insert_affected_set``
  heap search survives as the per-object oracle and as the ``frontier =
  "host"`` baseline pipeline) against the pre-update k-th distances; then one
  ``ops.rows_purge_merge`` over the union of the hit rows and the frontier
  drops the deleted entries, merges the insert candidates and recompacts every
  affected row. Jacobi rounds of the construction merge (``ops.sweep_merge``
  over the purged rows' bridge neighbourhoods) then repair the deletion holes
  to a fixpoint: Algorithm 5's processDel, run breadth-first on device.

  The repair rounds use the merge's tile form (``inplace=False``): repaired
  rows read each other, so every row of a round must read the pre-round
  tables. On a GPU the in-place form would be a data race there, not only a
  semantic slip. The round compares the tile with the old rows, then scatters.

Queries always see the last *flushed* state: the staged queue is invisible
until ``flush_updates``, the paper's batch-update-arrival serving model.

Epochs and snapshot isolation: the tables are *epoch-versioned*. Torch tensors
are mutable, so a published epoch's tensors are never written: a flush CLONES
the epoch-e tables once, before its first write, builds epoch ``e+1`` on the
clone, and then performs one atomic swap (``EpochStore.publish``).
``query_batch`` resolves its table snapshot at dispatch, so a query sent at
ANY point during a flush reads a whole epoch, and a failed flush drops the
clone and puts the working references back on epoch ``e`` with the staged
queue intact (retryable; serving never stops). ``keep_epochs`` (the retention
E) bounds device memory at E published table versions plus one working copy
during a flush, and lets callers pin an older epoch:
``query_batch(..., epoch=e)``.

Fault injection: ``EngineCore._checkpoint(phase)`` is the chaos seam, a no-op
unless ``engine.checkpoint_hook`` is set. It fires at ``"mid-repair-round"``
(after each Jacobi repair round), ``"pre-swap"`` (epoch ``e+1`` built, not yet
published) and ``"post-swap"`` (published).

Host/device traffic per flush: the update script and affected-row indices go
up; a changed-row mask per frontier/repair round (which narrows the next
round's receiver set) and, once the frontier converges, the affected rows'
distance tiles come back. The k-th-distance column, the checkIns pruning
bound, never leaves the device. Queries move only the query ids up and the
(B, k) result tiles stay on the device until the caller reads them.

Not in this module yet: the write-ahead journal, ``save``/``load`` artifacts
and the sanitizer rail of the JAX package's engine.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.bngraph import BNGraph
from repro_torch.core.construct import build_knn_tables, resolve_device, tables_to_index
from repro_torch.core.errors import (
    EngineConfigError,
    EpochError,
    QueryError,
    StagedUpdateError,
)
from repro_torch.core.index import PAD_ID, KNNIndex
from repro_torch.core.updates import insert_affected_set
from repro_torch.kernels import ops

_MAX_REPAIR_ROUNDS = 256
_INF = float("inf")


class EpochStore:
    """Epoch number -> immutable table snapshot, with keep-last-E retention.

    The store is the engine's single source of "what do queries read": the
    newest published epoch is current, ``snapshot()`` resolves it at call
    time (dispatch-time snapshot = the snapshot-isolation contract), and
    ``snapshot(e)`` pins an older retained epoch. Retention is strict
    keep-last-E: publishing epoch ``e`` evicts everything below
    ``e - keep + 1``, which bounds device memory at E table versions.
    Snapshots are tuples of tensors that nobody writes after publication
    (the engine clones before a flush's first write), so retaining one is a
    reference, not a copy.
    """

    def __init__(self, keep: int = 2):
        self._snaps: OrderedDict[int, tuple] = OrderedDict()
        self._keep = 0
        self.keep = keep

    @property
    def keep(self) -> int:
        return self._keep

    @keep.setter
    def keep(self, e: int) -> None:
        e = int(e)
        if e < 1:
            raise EpochError(f"keep_epochs must be >= 1, got {e}")
        self._keep = e
        self._evict()

    @property
    def current(self) -> int:
        return next(reversed(self._snaps)) if self._snaps else -1

    def epochs(self) -> list[int]:
        return list(self._snaps)

    def publish(self, epoch: int, snap: tuple) -> None:
        """Atomically make ``epoch`` current (one dict insert: a query that
        resolved its snapshot before this call keeps reading the old epoch's
        tensors, which stay alive via its reference)."""
        self._snaps[epoch] = snap
        self._evict()

    def _evict(self) -> None:
        while len(self._snaps) > self._keep:
            self._snaps.popitem(last=False)

    def snapshot(self, epoch: int | None = None) -> tuple:
        return self.resolve(epoch)[1]

    def resolve(self, epoch: int | None = None) -> tuple[int, tuple]:
        """Resolve ``epoch`` (None = current, at call time) to the concrete
        ``(epoch number, snapshot)`` pair in one read."""
        if epoch is None:
            epoch = self.current
        else:
            epoch = int(epoch)
        if epoch not in self._snaps:
            raise EpochError(
                f"epoch {epoch} is not retained (have {self.epochs()}); "
                f"raise keep_epochs to pin more history"
            )
        return epoch, self._snaps[epoch]


def _pow2_pad(x: int, lo: int = 8) -> int:
    """Next power of two >= x (>= lo)."""
    return max(lo, 1 << (max(1, x) - 1).bit_length())


class EngineCore:
    """Layout-independent serving core: the staged queue and its coalescing,
    query bookkeeping, the flush orchestration (delete scan -> batched device
    checkIns frontier -> fused purge+merge -> breadth-first repair with its
    changed-row frontier narrowing), epochs and the stats surface.

    A subclass owns the table storage and implements the device hooks:

    * ``_gather_batch(us, ks, snap, epoch)``: the batched row gather behind
      ``query_batch``, reading the ``snap`` epoch snapshot, never the working
      tables, so queries stay snapshot-isolated from an in-flight flush.
    * ``_table_snapshot()``: the current working tables as a snapshot tuple,
      published to the ``EpochStore`` at each flush commit. From then on the
      subclass must not write through those tensors.
    * ``_restore_tables(snap)``: reset the working references to a snapshot
      (the failed-flush rollback path).
    * ``_scan_delete_rows(deletes)``: row ids naming any deleted object.
    * ``_purge_merge(rows, deletes, cand_ids, cand_d)``: the fused purge +
      candidate merge over one row batch.
    * ``_repair_part(part)``: one Jacobi re-merge of ``part`` rows against
      their bridge neighbourhoods; returns the per-row changed mask.
    * the frontier seam: ``_frontier_init(src)`` allocates the multi-source
      tentative-distance state for one staged insert batch,
      ``_frontier_part(state, part)`` runs one pruned-relaxation round over a
      receiver-row bucket (returning the new state + changed mask), and
      ``_frontier_extract(state, rows, src)`` reads back the affected mask
      and distances for the touched rows.
    * ``_table_kth()``: the (n,) k-th-distance column (float64 host array),
      read only by the ``frontier = "host"`` baseline pipeline.
    * ``to_index()``: readback into the host ``KNNIndex`` view.
    """

    def __init__(self, k: int, objects, *, bn: BNGraph | None, use_kernel: bool):
        # subclasses set ``self.n`` (and their tables) before calling super()
        self.k = int(k)
        self.use_kernel = bool(use_kernel)
        self.bn = bn
        self.frontier = "device"  # validated setter, see the property below
        obj = {int(o) for o in np.asarray(objects).ravel()}
        self._objects = obj
        self._pending = set(obj)
        self._staged: list[tuple] = []
        self._nbr_ids: np.ndarray | None = None
        self._nbr_w: np.ndarray | None = None
        self._nbr_deg: np.ndarray | None = None
        self._nbr_by_t: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._stats = {
            "queries_served": 0,
            "query_batches": 0,
            "last_batch_size": 0,
            "flushes": 0,
            "flushes_failed": 0,
            "inserts_applied": 0,
            "deletes_applied": 0,
            "moves_applied": 0,
            "coalesced": 0,
            "rows_repaired": 0,
            "repair_rounds_last": 0,
            "frontier_rounds_last": 0,
            "t_frontier_s": 0.0,
            "t_purge_merge_s": 0.0,
            "t_repair_s": 0.0,
        }
        # epoch 0 is the constructor tables; every flush publishes the next
        # epoch and queries resolve their snapshot at dispatch
        self.checkpoint_hook = None  # chaos seam: fn(engine, phase) or None
        self._epochs = EpochStore(keep=2)
        self._epoch_stats: dict[int, dict] = {}
        self._publish_epoch(0)
        self._epoch_stats[0] = {"origin": "build"}

    @property
    def frontier(self) -> str:
        """Which checkIns pipeline ``flush_updates`` runs: ``"device"``
        (default) is the batched multi-source ``ops.frontier_relax`` rounds;
        ``"host"`` replays the per-object ``insert_affected_set`` heap search
        (the measurable baseline and the oracle's twin). Flipping pipelines
        mid-life is safe (both produce identical tables); anything but the
        two known modes raises."""
        return self._frontier

    @frontier.setter
    def frontier(self, mode: str) -> None:
        if mode not in ("device", "host"):
            raise EngineConfigError(f"frontier must be 'device' or 'host', got {mode!r}")
        self._frontier = mode

    # ------------------------------------------------------------------
    # epochs / fault injection
    # ------------------------------------------------------------------

    @property
    def epoch(self) -> int:
        """The current serving epoch: 0 at construction, +1 per flush."""
        return self._epochs.current

    @property
    def keep_epochs(self) -> int:
        """Retention E: how many table epochs stay resident (>= 1). Raising E
        lets callers pin older epochs via ``query_batch(..., epoch=e)``;
        lowering it evicts immediately."""
        return self._epochs.keep

    @keep_epochs.setter
    def keep_epochs(self, e: int) -> None:
        self._epochs.keep = e
        self._trim_epoch_stats()

    def retained_epochs(self) -> list[int]:
        return self._epochs.epochs()

    def epoch_stats(self, epoch: int | None = None) -> dict:
        """Per-epoch provenance: how the retained epoch was produced
        (``origin`` build/flush plus the flush's stats dict and wall time).
        Raises ``EpochError`` for evicted/unknown epochs."""
        epoch = self._epochs.current if epoch is None else int(epoch)
        if epoch not in self._epoch_stats:
            raise EpochError(
                f"epoch {epoch} has no retained stats (have {sorted(self._epoch_stats)})"
            )
        return dict(self._epoch_stats[epoch])

    def _trim_epoch_stats(self) -> None:
        kept = set(self._epochs.epochs())
        self._epoch_stats = {e: s for e, s in self._epoch_stats.items() if e in kept}

    def _publish_epoch(self, epoch: int) -> None:
        """Publish the working tables as ``epoch`` (the atomic swap): the ONE
        place an epoch becomes visible."""
        self._epochs.publish(epoch, self._table_snapshot())

    def _checkpoint(self, phase: str) -> None:
        """Fault-injection seam: no-op unless ``checkpoint_hook`` is set.

        A test installs a hook that raises (simulated kill-at-this-point) or
        sends queries (snapshot-isolation probes). Phases fired:
        ``mid-repair-round``, ``pre-swap``, ``post-swap``.
        """
        hook = self.checkpoint_hook
        if hook is not None:
            hook(self, phase)

    @staticmethod
    def normalize_tables(ids, dists, k: int, bn: BNGraph | None, device):
        """Validate and normalize constructor tables to the engine layout.

        Accepts host (numpy) or device (n, k) tables, or (n+1, k) tables
        straight from the construction sweeps (dummy gather row already last,
        only recognized when ``bn`` pins down n); returns ``(n, ids, dists)``
        on ``device`` as contiguous int32 / float32 with the dummy row
        (PAD_ID, +inf) guaranteed present.
        """
        ids = torch.as_tensor(ids).to(device=device, dtype=torch.int32).contiguous()
        dists = torch.as_tensor(dists).to(device=device, dtype=torch.float32).contiguous()
        if ids.ndim != 2 or ids.shape != dists.shape or ids.shape[1] != k:
            raise ValueError(f"tables must be (n, k)={tuple(ids.shape)} with k={k}")
        if bn is not None and ids.shape[0] not in (bn.n, bn.n + 1):
            raise ValueError(f"tables have {ids.shape[0]} rows but graph has n={bn.n}")
        if bn is not None and ids.shape[0] == bn.n + 1:
            return ids.shape[0] - 1, ids, dists
        n = int(ids.shape[0])
        ids = torch.cat([ids, torch.full((1, k), PAD_ID, dtype=torch.int32, device=device)])
        dists = torch.cat([dists, torch.full((1, k), _INF, dtype=torch.float32, device=device)])
        return n, ids, dists

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def _ks_array(self, b: int, k) -> tuple[np.ndarray, int]:
        if k is None:
            return np.full((b,), self.k, np.int32), self.k
        ks = np.asarray(k, dtype=np.int32)
        if ks.ndim == 0:
            if int(ks) > self.k:
                raise QueryError(f"query k={int(ks)} exceeds index k={self.k}")
            return np.full((b,), int(ks), np.int32), int(ks)
        if ks.shape != (b,):
            raise QueryError(f"per-query k must have shape ({b},), got {ks.shape}")
        if ks.size and int(ks.max()) > self.k:
            raise QueryError(f"per-query k max={int(ks.max())} exceeds index k={self.k}")
        return ks, self.k

    def _gather_batch(self, us: np.ndarray, ks: np.ndarray, snap: tuple, epoch: int):
        raise NotImplementedError

    def query_batch(self, us, k=None, *, epoch=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched kNN: (B,) vertices -> ((B, k') ids, (B, k') dists), tensors
        on the engine's device.

        ``k`` may be None (index k), a scalar, or a (B,) array for mixed-k
        traffic; columns past a query's k hold the pad sentinel (-1, +inf).
        Raises ``QueryError`` when any requested k exceeds the index's k.

        ``epoch`` pins the read to a retained older epoch (``EpochError`` if
        evicted); by default the snapshot is resolved at dispatch, so a flush
        in progress can neither block the query nor leak it a
        partially-repaired table.
        """
        us = np.asarray(us, dtype=np.int32)
        if us.ndim != 1:
            raise QueryError(f"queries must be a 1-D vertex array, got {us.shape}")
        epoch_r, snap = self._epochs.resolve(epoch)
        ks, width = self._ks_array(us.shape[0], k)
        ids, d = self._gather_batch(us, ks, snap, epoch_r)
        self._stats["queries_served"] += int(us.shape[0])
        self._stats["query_batches"] += 1
        self._stats["last_batch_size"] = int(us.shape[0])
        if width < self.k:
            ids, d = ids[:, :width], d[:, :width]
        return ids, d

    def query_progressive_batch(
        self, us, k=None, *, epoch=None
    ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """Progressive batched output: yields the first-i prefix for
        i = 1..k from ONE gather (Theorem 4.4, batched)."""
        ids, d = self.query_batch(us, k, epoch=epoch)
        for i in range(1, ids.shape[1] + 1):
            yield ids[:, :i], d[:, :i]

    # ------------------------------------------------------------------
    # staged updates
    # ------------------------------------------------------------------

    def _check_vertex(self, u: int) -> int:
        u = int(u)
        if not 0 <= u < self.n:
            raise StagedUpdateError(f"vertex {u} out of range [0, {self.n})")
        if self.bn is None:
            raise RuntimeError("updates need the BN-Graph; build the engine with bn=")
        return u

    def stage_insert(self, u: int) -> int:
        """Queue an object insertion; returns the staged-queue depth."""
        u = self._check_vertex(u)
        if u in self._pending:
            raise StagedUpdateError(f"object {u} already present (or staged for insert)")
        self._pending.add(u)
        self._staged.append(("ins", u))
        return len(self._staged)

    def stage_delete(self, u: int) -> int:
        """Queue an object deletion; returns the staged-queue depth."""
        u = self._check_vertex(u)
        if u not in self._pending:
            raise StagedUpdateError(f"object {u} absent (or staged for delete)")
        self._pending.discard(u)
        self._staged.append(("del", u))
        return len(self._staged)

    def stage_move(self, u: int, v: int) -> int:
        """Queue an object movement u -> v; returns the staged-queue depth.

        The moving-objects primitive: the object at vertex u relocates to
        vertex v. At flush time move chains collapse to their endpoints and
        the source purge, destination checkIns frontier and repair rounds all
        run as one fused device batch.
        """
        u = self._check_vertex(u)
        v = self._check_vertex(v)
        if u == v:
            raise StagedUpdateError(f"move source and destination are both {u}")
        if u not in self._pending:
            raise StagedUpdateError(f"object {u} absent (or staged for delete)")
        if v in self._pending:
            raise StagedUpdateError(f"object {v} already present (or staged for insert)")
        self._pending.discard(u)
        self._pending.add(v)
        self._staged.append(("mov", u, v))
        return len(self._staged)

    @property
    def queue_depth(self) -> int:
        return len(self._staged)

    @property
    def objects(self) -> np.ndarray:
        """The flushed candidate-object set M (staged updates not included)."""
        return np.array(sorted(self._objects), dtype=np.int32)

    def _nbr_tables(self) -> None:
        """Bind the BN-Graph's combined BNS adjacency (``bns_packed``).

        Valid neighbours are compacted to the front of each row, so a row with
        degree d is fully described by the first d columns; frontier and
        repair rounds then run on the (n+1, t) column slice of the smallest
        pow4 bucket t >= the batch rows' max degree instead of the global
        tau'. The padded host tables are built once per BNGraph; the per-width
        device slices are cached per engine (``_nbr_slice``).
        """
        if self._nbr_ids is None:
            packed = self.bn.bns_packed()
            self._nbr_ids = packed.ids
            self._nbr_w = packed.w
            self._nbr_deg = packed.deg
            self._nbr_indptr = packed.indptr
            self._nbr_indices = packed.indices

    def _t_bucket(self, rows: np.ndarray) -> int:
        """Smallest pow4 width (>= 8) covering the rows' max BNS degree."""
        t_max = int(self._nbr_deg[rows].max())
        t = 8
        while t < t_max:
            t *= 4
        return min(t, self._nbr_ids.shape[1])

    # hooks the flush pipeline drives -----------------------------------

    def _table_snapshot(self) -> tuple:
        raise NotImplementedError

    def _restore_tables(self, snap: tuple) -> None:
        raise NotImplementedError

    def _table_bytes(self) -> int:
        """Device bytes of ONE table epoch (int32 ids + float32 dists)."""
        return (self.n + 1) * self.k * 8

    def _scan_delete_rows(self, deletes: list[int]) -> np.ndarray:
        raise NotImplementedError

    def _table_kth(self) -> np.ndarray:
        raise NotImplementedError

    def _purge_merge(self, rows, deletes, cand_ids, cand_d) -> None:
        raise NotImplementedError

    def _repair_part(self, part: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _frontier_init(self, src: np.ndarray):
        raise NotImplementedError

    def _frontier_part(self, state, part: np.ndarray):
        raise NotImplementedError

    def _frontier_round(self, state, nbrs: np.ndarray):
        """One frontier round over receiver set ``nbrs``: bucket by BNS
        degree, enqueue each part, then read the changed masks back once the
        whole round is queued (a mask is a device tensor until then, so the
        later buckets' upload work overlaps the earlier buckets' compute)."""
        pending = []
        for part in self._bucket_parts(nbrs):
            state, changed_mask = self._frontier_part(state, part)
            pending.append((part, changed_mask))
        changed_parts = [p[m.cpu().numpy()] for p, m in pending]
        return state, changed_parts

    def _frontier_extract(self, state, rows: np.ndarray, src: np.ndarray):
        raise NotImplementedError

    def _bucket_parts(self, rows: np.ndarray):
        """Split a row batch by BNS-degree width bucket (8/32/128/tau').

        Shared by the repair and frontier rounds: each part runs against the
        (n+1, t) adjacency slice of its bucket, so the per-round work is sized
        to the batch, not to the global tau'. The split is a pure function of
        the row ids and is the JAX engine's, so the two engines walk the same
        round trajectory.
        """
        deg = self._nbr_deg[rows]
        cap = self._nbr_ids.shape[1]
        prev = 0
        for t in [b for b in (8, 32, 128) if b < cap] + [cap]:
            part = rows[(deg > prev) & (deg <= t)]
            prev = t
            if part.size:
                yield part

    def _repair(self, rows: np.ndarray) -> int:
        """Jacobi repair rounds over the purged rows; returns the round count.

        Round 1 re-merges every purged row; later rounds only the frontier:
        a row can improve again only if a BNS neighbour's row changed last
        round (BN adjacency is symmetric, so BNS(changed) IS that set). Only
        the frontier's *vertex ids* survive a round boundary; the row data
        never leaves the device between rounds.
        """
        self._nbr_tables()
        active = rows
        rounds = 0
        while active.size and rounds < _MAX_REPAIR_ROUNDS:
            changed_parts = []
            for part in self._bucket_parts(active):
                changed_mask = self._repair_part(part)
                changed_parts.append(part[changed_mask])
            rounds += 1
            self._checkpoint("mid-repair-round")
            changed_rows = (
                np.concatenate(changed_parts) if changed_parts else np.empty(0, np.int32)
            )
            if changed_rows.size == 0:
                break
            active = self._repair_receivers(changed_rows, rows)
        else:
            if active.size:
                raise RuntimeError(
                    f"delete repair did not reach a fixpoint in {_MAX_REPAIR_ROUNDS} rounds"
                )
        return rounds

    def _insert_frontier(
        self, inserts: list[int]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Batched checkIns frontier on device: Algorithm 4 lines 1-8 for ALL
        staged inserts as multi-source pruned-relaxation rounds.

        Round r relaxes the BNS edges of every vertex whose tentative distance
        changed in round r-1 (round 1: the sources themselves), pruned on
        device by the live k-th-distance column, the checkIns test
        ``d < kth[w]``. Only changed-row masks and, after convergence, the
        affected rows' distance tiles cross the host boundary. Returns
        ``(rows, cand_ids, cand_d, rounds)``: the affected rows (sorted) with
        their per-row compacted (inserted object, exact distance) candidate
        lists, the same contract as the ``frontier = "host"`` pipeline (the
        pruned-relaxation fixpoint is schedule-independent, so the Dijkstra
        oracle and these Jacobi rounds land on identical sets and distances).
        """
        self._nbr_tables()
        src = np.asarray(inserts, np.int32)
        state = self._frontier_init(src)
        active = np.unique(src)
        touched = [active]
        rounds = 0
        while active.size and rounds < _MAX_REPAIR_ROUNDS:
            nbrs = self._expand_receivers(active)
            state, changed_parts = self._frontier_round(state, nbrs)
            rounds += 1
            active = (
                np.concatenate(changed_parts) if changed_parts else np.empty(0, np.int32)
            )
            if active.size:
                touched.append(active)
        if active.size:
            raise RuntimeError(
                f"checkIns frontier did not reach a fixpoint in {_MAX_REPAIR_ROUNDS} rounds"
            )
        rows = np.unique(np.concatenate(touched)).astype(np.int32)
        aff, dvals = self._frontier_extract(state, rows, src)
        return (*self._compact_candidates(rows, aff, dvals, src), rounds)

    def _repair_receivers(self, changed: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Next repair round's active set: the BNS neighbourhoods of the rows
        that changed, narrowed to the purged batch."""
        nbrs = np.unique(
            np.concatenate(
                [self.bn.lo_ids[changed].ravel(), self.bn.hi_ids[changed].ravel()]
            )
        )
        return np.intersect1d(nbrs[nbrs >= 0], rows).astype(np.int32)

    def _expand_receivers(self, active: np.ndarray) -> np.ndarray:
        """Next round's receiver set: the union of BNS neighbourhoods of the
        changed vertices, via the packed adjacency's CSR triple (touches
        exactly the live edges, no padded columns)."""
        starts = self._nbr_indptr[active]
        counts = self._nbr_indptr[active + 1] - starts
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, np.int32)
        exc = np.concatenate([[0], np.cumsum(counts)[:-1]])
        idx = np.repeat(starts - exc, counts) + np.arange(total)
        return np.unique(self._nbr_indices[idx]).astype(np.int32)

    @staticmethod
    def _compact_candidates(
        rows: np.ndarray, aff: np.ndarray, dvals: np.ndarray, src: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(touched rows, (R, B) affected mask + distances) -> the flush's
        per-row candidate arrays: affected columns compacted to the front in
        source order, width pow2-padded, the exact layout the host frontier
        builds, so ``_purge_merge`` sees identical inputs either way."""
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

    def _insert_frontier_host(
        self, inserts: list[int]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """The pre-batching checkIns pipeline: one sequential host heap search
        per staged insert (``insert_affected_set``, shared with the scalar
        oracle) fed by a full (n,) k-th-distance readback. Kept as the
        ``frontier = "host"`` baseline and as the property tests' twin."""
        kth = self._table_kth()
        per_row: dict[int, list[tuple[int, float]]] = {}
        for u in inserts:
            affected = insert_affected_set(self.bn, lambda v: float(kth[v]), u)
            for v, d in affected.items():
                per_row.setdefault(v, []).append((u, d))
        rows = np.fromiter(sorted(per_row), np.int32, len(per_row))
        if rows.size == 0:
            return rows, np.empty((0, 1), np.int32), np.empty((0, 1), np.float32), 0
        p = _pow2_pad(max(len(c) for c in per_row.values()), lo=4)
        cand_ids = np.full((len(rows), p), -1, np.int32)
        cand_d = np.full((len(rows), p), np.inf, np.float32)
        for i, v in enumerate(rows.tolist()):
            for j, (u, d) in enumerate(per_row[v]):
                cand_ids[i, j] = u
                cand_d[i, j] = d
        return rows, cand_ids, cand_d, 0

    def _coalesced_moves(self, deletes: set, inserts: set) -> list[tuple[int, int]]:
        """Fold the staged queue's move chains to (origin, endpoint) pairs.

        Only chains whose origin is a net delete AND whose endpoint is a net
        insert count as moves; everything else has already coalesced away in
        the object-set delta. Purely a classification for the stats dict: the
        applied work is always the net set delta.
        """
        chain: dict[int, int] = {}  # current endpoint -> chain origin
        for op in self._staged:
            if op[0] == "mov":
                _, u, v = op
                chain[v] = chain.pop(u, u)
            else:
                chain.pop(op[1], None)  # a delete at the endpoint kills the chain
        # Two chains can share an origin (move away, re-insert at the origin,
        # move away again), so pair each origin/endpoint at most once.
        avail_o, avail_c = set(deletes), set(inserts)
        moves = []
        for c, o in sorted(chain.items()):
            if o != c and o in avail_o and c in avail_c:
                moves.append((o, c))
                avail_o.discard(o)
                avail_c.discard(c)
        return moves

    def flush_updates(self) -> dict:
        """Apply the staged queue as one fused vectorized device batch.

        The queue is coalesced to its net object-set delta. Application: find
        the delete-hit rows, run the batched device checkIns frontier for ALL
        insertions at once against the pre-update k-th distances
        (insert-first semantics; ``self.frontier = "host"`` selects the
        per-object baseline pipeline instead), purge + merge the union of
        both row sets in one ``rows_purge_merge`` pass, then repair the
        deletion holes with breadth-first Jacobi rounds. Returns the
        per-flush stats dict (net insert/delete/move counts plus
        ``coalesced`` and the frontier/repair round counts); the cumulative
        per-phase wall times land in ``stats()`` as ``t_frontier_s`` /
        ``t_purge_merge_s`` / ``t_repair_s``.
        """
        t_wall0 = time.perf_counter()
        staged = len(self._staged)
        del_set = self._objects - self._pending
        ins_set = self._pending - self._objects
        deletes = sorted(del_set)
        inserts = sorted(ins_set)
        moves = self._coalesced_moves(del_set, ins_set)
        n_pure_ins = len(inserts) - len(moves)
        n_pure_del = len(deletes) - len(moves)

        # Epoch e+1 is built on a private clone of the epoch-e tables (made at
        # the first write); the published epoch e keeps its own tensors, so
        # queries dispatched anywhere in here still read a whole epoch. Any
        # failure (a device error, or a chaos hook's simulated kill) puts the
        # working references back on epoch e with the staged queue intact:
        # the flush is retryable and serving never stops.
        base = self._epochs.snapshot()
        try:
            # -- delete side: which rows name a deleted object (device scan) --
            purged_rows = np.empty(0, np.int32)
            if deletes:
                purged_rows = self._scan_delete_rows(deletes)

            # -- insert side: batched checkIns frontier, insert-first semantics --
            # The frontier prunes against the CURRENT (pre-update) k-th bounds,
            # exactly Algorithm 4 run before Algorithm 5 (the order the scalar
            # ``move_object`` oracle uses). A row the pruning misses that still
            # needs a new object in the *final* tables must have had its k-th
            # distance raised by the deletions, i.e. it lost an entry, so it is
            # in the purge set and the repair rounds rebuild it from its bridge
            # neighbours anyway.
            t0 = time.perf_counter()
            f_rounds = 0
            frows = np.empty(0, np.int32)
            fc_ids = fc_d = None
            if inserts:
                provider = (
                    self._insert_frontier_host
                    if self.frontier == "host"
                    else self._insert_frontier
                )
                frows, fc_ids, fc_d, f_rounds = provider(inserts)
            t_frontier = time.perf_counter() - t0

            # -- one fused purge + merge over the union of both row sets --
            rounds = 0
            t_purge = t_repair = 0.0
            if purged_rows.size or frows.size:
                t0 = time.perf_counter()
                rows = np.union1d(purged_rows, frows).astype(np.int32)
                p = fc_ids.shape[1] if frows.size else 1
                cand_ids = np.full((len(rows), p), -1, np.int32)
                cand_d = np.full((len(rows), p), np.inf, np.float32)
                if frows.size:
                    pos = np.searchsorted(rows, frows)
                    cand_ids[pos] = fc_ids
                    cand_d[pos] = fc_d
                self._purge_merge(rows, deletes, cand_ids, cand_d)
                t_purge = time.perf_counter() - t0
                # -- breadth-first repair of the deletion holes --
                if purged_rows.size:
                    t0 = time.perf_counter()
                    rounds = self._repair(purged_rows)
                    t_repair = time.perf_counter() - t0
            self._checkpoint("pre-swap")
        except BaseException:
            self._restore_tables(base)
            self._stats["flushes_failed"] += 1
            raise

        # -- atomic swap: publish epoch e+1 --
        self._objects = set(self._pending)
        self._staged.clear()
        new_epoch = self.epoch + 1
        self._publish_epoch(new_epoch)
        self._stats["flushes"] += 1
        self._stats["inserts_applied"] += n_pure_ins
        self._stats["deletes_applied"] += n_pure_del
        self._stats["moves_applied"] += len(moves)
        self._stats["coalesced"] += staged - (n_pure_ins + n_pure_del + len(moves))
        self._stats["rows_repaired"] += int(purged_rows.size) + int(frows.size)
        self._stats["repair_rounds_last"] = rounds
        self._stats["frontier_rounds_last"] = f_rounds
        self._stats["t_frontier_s"] += t_frontier
        self._stats["t_purge_merge_s"] += t_purge
        self._stats["t_repair_s"] += t_repair
        result = {
            "staged": staged,
            "inserts": n_pure_ins,
            "deletes": n_pure_del,
            "moves": len(moves),
            "coalesced": staged - (n_pure_ins + n_pure_del + len(moves)),
            "rows_purged": int(purged_rows.size),
            "rows_merged": int(frows.size),
            "repair_rounds": rounds,
            "frontier_rounds": f_rounds,
        }
        self._epoch_stats[new_epoch] = {
            "origin": "flush",
            "flush": dict(result),
            "t_wall_s": time.perf_counter() - t_wall0,
        }
        self._trim_epoch_stats()
        self._checkpoint("post-swap")
        return result

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        """Serving counters."""
        retained = self.retained_epochs()
        return {
            "n": self.n,
            "k": self.k,
            "num_objects": len(self._objects),
            "staged_queue_depth": len(self._staged),
            "epoch": self.epoch,
            "epochs_retained": len(retained),
            "keep_epochs": self.keep_epochs,
            "epoch_table_bytes": len(retained) * self._table_bytes(),
            **self._stats,
        }


class QueryEngine(EngineCore):
    """Batched kNN serving over device-resident index tables (see module doc)."""

    def __init__(
        self,
        ids,
        dists,
        k: int,
        objects,
        *,
        bn: BNGraph | None = None,
        device="cuda",
        use_kernel: bool = True,
    ):
        self.device = resolve_device(device)
        self.n, self._vk_ids, self._vk_d = self.normalize_tables(
            ids, dists, k, bn, self.device
        )
        super().__init__(k, objects, bn=bn, use_kernel=use_kernel)

    # ------------------------------------------------------------------
    # construction / conversion
    # ------------------------------------------------------------------

    @classmethod
    def build(
        cls, bn: BNGraph, objects: np.ndarray, k: int, *, device="cuda", use_kernel: bool = True
    ) -> "QueryEngine":
        """Construct on device (Algorithm 3 sweeps) and serve in place: the
        sweep result tables become the engine's live tables, no readback."""
        vk_ids, vk_d = build_knn_tables(bn, objects, k, device=device, use_kernel=use_kernel)
        return cls(vk_ids, vk_d, k, objects, bn=bn, device=device, use_kernel=use_kernel)

    @classmethod
    def from_tables(
        cls, ids, dists, k: int, objects, *, bn: BNGraph | None = None,
        device="cuda", use_kernel: bool = True,
    ) -> "QueryEngine":
        """An engine over tables computed elsewhere, given as numpy arrays of
        shape (n, k) or (n+1, k) (dummy row last; see ``normalize_tables``).
        The arrays are copied to ``device``; the caller's buffers are never
        written."""
        ids = np.array(ids, dtype=np.int32)
        dists = np.array(dists, dtype=np.float32)
        return cls(ids, dists, k, objects, bn=bn, device=device, use_kernel=use_kernel)

    @classmethod
    def from_index(
        cls, index: KNNIndex, objects, *, bn: BNGraph | None = None,
        device="cuda", use_kernel: bool = True,
    ) -> "QueryEngine":
        """Upload a host ``KNNIndex`` (e.g. an oracle-built one)."""
        dists = np.where(index.ids >= 0, index.dists, np.inf).astype(np.float32)
        return cls.from_tables(
            index.ids, dists, index.k, objects, bn=bn, device=device, use_kernel=use_kernel
        )

    def to_index(self) -> KNNIndex:
        """Read the tables back into the host ``KNNIndex`` view (oracle dtype)."""
        return tables_to_index(self._vk_ids, self._vk_d, self.n, self.k)

    @property
    def tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The live device (n+1, k) id/dist tables (dummy row last). Between
        flushes these ARE the current epoch's tensors: read, do not write."""
        return self._vk_ids, self._vk_d

    # ------------------------------------------------------------------
    # device hooks (single-device layout)
    # ------------------------------------------------------------------

    def _table_snapshot(self) -> tuple[torch.Tensor, torch.Tensor]:
        # publishing hands the working tensors to the epoch store: from here
        # on they are shared with readers and must be cloned before a write
        self._tables_shared = True
        return self._vk_ids, self._vk_d

    def _restore_tables(self, snap: tuple) -> None:
        self._vk_ids, self._vk_d = snap
        self._tables_shared = True

    def _own_tables(self) -> None:
        """Copy-on-first-write: make the working tables private to the flush."""
        if self._tables_shared:
            self._vk_ids = self._vk_ids.clone()
            self._vk_d = self._vk_d.clone()
            self._tables_shared = False

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _gather_batch(self, us: np.ndarray, ks: np.ndarray, snap: tuple, epoch: int):
        return ops.serve_gather(snap[0], snap[1], self._upload(us), self._upload(ks))

    def _scan_delete_rows(self, deletes: list[int]) -> np.ndarray:
        del_arr = self._upload(np.asarray(deletes, np.int32))
        hit = ops.rows_containing(self._vk_ids, del_arr)
        return torch.nonzero(hit).ravel().cpu().numpy().astype(np.int32)

    def _table_kth(self) -> np.ndarray:
        return self._vk_d[: self.n, -1].cpu().numpy().astype(np.float64)

    def _purge_merge(self, rows, deletes, cand_ids, cand_d) -> None:
        self._own_tables()
        # an empty delete list still needs one id to test against: n is never
        # an object id, so never a hit
        del_arr = np.asarray(deletes if deletes else [self.n], np.int32)
        ops.rows_purge_merge(
            self._vk_ids, self._vk_d, self._upload(rows), self._upload(del_arr),
            self._upload(cand_ids), self._upload(cand_d), self.k,
            use_kernel=self.use_kernel,
        )

    def _nbr_slice(self, t: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Device (n+1, t) adjacency slice for one width bucket, cached."""
        if t not in self._nbr_by_t:
            self._nbr_by_t[t] = (
                self._upload(self._nbr_ids[:, :t]),
                self._upload(self._nbr_w[:, :t]),
            )
        return self._nbr_by_t[t]

    def _repair_part(self, part: np.ndarray) -> np.ndarray:
        self._own_tables()
        nbr_tab, w_tab = self._nbr_slice(self._t_bucket(part))
        changed = _repair_round(
            nbr_tab, w_tab, self._upload(part), self._vk_ids, self._vk_d, self.use_kernel
        )
        return changed.cpu().numpy()

    # frontier provider: the multi-source tentative distance state is one
    # (n+1, B) device matrix, private to the flush and updated in place
    # between rounds; the pruning column is sliced off the live table once
    # per flush (the tables do not change while the frontier runs), so no
    # kth value ever crosses the host boundary.

    def _frontier_init(self, src: np.ndarray) -> torch.Tensor:
        self._fsrc = self._upload(src)
        self._fkth = self._vk_d[:, -1].contiguous()
        return _frontier_init_prog(self._fsrc, self._vk_ids.shape[0])

    def _frontier_part(self, state, part: np.ndarray):
        nbr_tab, w_tab = self._nbr_slice(self._t_bucket(part))
        changed = _frontier_round(
            nbr_tab, w_tab, self._upload(part), state, self._fkth, self._fsrc,
            self.use_kernel,
        )
        return state, changed

    def _frontier_extract(self, state, rows: np.ndarray, src: np.ndarray):
        aff, d = _frontier_affected(self._upload(rows), state, self._fkth, self._fsrc)
        return aff.cpu().numpy(), d.cpu().numpy()


def _frontier_init_prog(src: torch.Tensor, n1: int) -> torch.Tensor:
    """Allocate the (n+1, B) multi-source tentative-distance matrix: +inf
    everywhere except 0 at (src[i], i)."""
    b = src.shape[0]
    dist = torch.full((n1, b), _INF, dtype=torch.float32, device=src.device)
    dist[src.long(), torch.arange(b, device=src.device)] = 0.0
    return dist


def _frontier_round(nbr_tab, w_tab, rows, dist, kth, src, use_kernel: bool) -> torch.Tensor:
    """One frontier round: gather the receiver rows' BNS slices, run
    ``ops.frontier_relax`` against the k-th column, derive the changed mask
    that narrows the next round's receiver set (distances only ever decrease,
    so ``new < old`` is exactly "changed"), then store the new rows into
    ``dist`` in place. Every relaxation read saw the pre-round ``dist``."""
    idx = rows.long()
    new = ops.frontier_relax(
        nbr_tab[idx], rows, w_tab[idx], dist, kth, src, use_kernel=use_kernel
    )
    changed = (new < dist[idx]).any(dim=1)
    dist[idx] = new
    return changed


def _frontier_affected(rows, dist, kth, src):
    """Affected test for the touched rows after convergence: checkIns against
    the k-th column, plus the source rows themselves (Algorithm 4 admits the
    inserted object unconditionally). Returns the (R, B) mask and the distance
    tile, the only frontier data read back to the host."""
    idx = rows.long()
    d = dist[idx]
    aff = (d < kth[idx][:, None]) | (rows[:, None] == src[None, :])
    return aff, d


def _repair_round(nbr_tab, w_tab, rows, vk_ids, vk_d, use_kernel: bool) -> torch.Tensor:
    """One Jacobi repair round, in place on (vk_ids, vk_d): every row in
    ``rows`` re-merges its own entries (extras tables = the live tables
    themselves) with its bridge neighbours' rows, all reading the pre-round
    tables (``inplace=False`` merge, then compare, then scatter). Returns the
    per-row changed mask the caller uses to narrow the next round."""
    k = vk_ids.shape[1]
    idx = rows.long()
    new_ids, new_d = ops.sweep_merge(
        nbr_tab[idx], rows, w_tab[idx], vk_ids, vk_d, vk_ids, vk_d, k,
        inplace=False, use_kernel=use_kernel,
    )
    changed = ((new_ids != vk_ids[idx]) | (new_d != vk_d[idx])).any(dim=1)
    vk_ids[idx] = new_ids
    vk_d[idx] = new_d
    return changed
