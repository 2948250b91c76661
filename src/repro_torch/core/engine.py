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
  (``ops.frontier_relax_rows`` with changed-frontier narrowing, see
  ``QueryEngine._insert_frontier``; the host ``updates.insert_affected_set``
  heap search survives as the per-object oracle and as the ``frontier =
  "host"`` baseline pipeline) against the pre-update k-th distances; then one
  ``ops.rows_purge_merge`` over the union of the hit rows and the frontier
  drops the deleted entries, merges the insert candidates and recompacts every
  affected row. Jacobi rounds of the construction merge (``ops.sweep_merge``
  over the purged rows' bridge neighbourhoods) then repair the deletion holes
  to a fixpoint: Algorithm 5's processDel, run breadth-first on device.

  The repair rounds use ``ops.sweep_merge``, which returns the merged rows as
  a tile and only reads the tables: repaired rows read each other, so every
  row of a round must read the pre-round tables. On a GPU an in-place merge
  would be a data race there, not only a semantic slip. The round compares
  the tile with the old rows, then scatters.

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

Durability: ``attach_journal`` / ``load(..., journal=...)`` pair the engine
with a write-ahead ``repro_torch.core.journal.UpdateJournal``: staged ops are
fsync'd before the stage call returns, a flush appends an epoch marker after
its swap, and ``load`` replays the journal through the staged path (flushing
at each commit marker, then rolling any uncommitted tail forward as one final
flush), so a killed process recovers to identical tables. ``save`` writes the
npz artifact (format version 3, a content checksum over ids, dists and
objects) that the JAX package writes too, and ``load_artifact`` raises a
typed ``ArtifactError`` on a truncated file, a checksum mismatch or a newer
format version; an artifact or a journal written by either package loads in
the other.

Fault injection: ``EngineCore._checkpoint(phase)`` is the chaos seam, a no-op
unless ``engine.checkpoint_hook`` is set. It fires at
``"post-journal-append"`` (a staged op just hit disk), ``"mid-repair-round"``
(after each Jacobi repair round), ``"pre-swap"`` (epoch ``e+1`` built, not yet
published) and ``"post-swap"`` (published and journal-committed).

Host/device traffic per flush: the update script and the purged rows go
up once. Each frontier and repair round builds its receiver parts on the
device from the changed masks the parts before it left there
(``QueryEngine._receiver_parts``) and reads back only the parts' sizes; the
touched-row mask comes back once the frontier converges, then one count a
touched row. The affected test and the compaction of the (rows x sources)
frontier tile into per-row candidate lists run on the device, and the lists
stay there for the purge + merge. The k-th-distance column, the checkIns
pruning bound, never leaves the device. (The sharded engine's rounds build
their receiver sets on the host: ``repro_torch.core.sharded``.) Queries move
only the query ids up and the (B, k) result tiles stay on the device until
the caller reads them.

Spans and counters (``repro_torch.trace``): ``repro_torch.flush_updates``
around the whole flush, and inside it ``repro_torch.flush.delete_scan``,
``.frontier``, ``.purge_merge`` and ``.repair``; its counters are
``d2h_bytes`` (every ``_readback``), ``frontier_rounds``, ``repair_rounds``,
``rows_touched`` (the rows the frontier's state touched) and, on the scalar
engine, ``k3_bytes`` (K3's least bytes over the flush's launches,
``_k3_least_bytes``) and ``receiver_rows`` (the rows of every receiver set
built on the device: each frontier round's, and each repair round's after
the first, which is the purged rows).

Sanitizer rail (``repro_torch.analysis.sanitize``): every crossing on the
query and device-flush paths goes through ``EngineCore._upload`` or
``EngineCore._readback``, the two explicit crossings, which
``count_transfers`` counts. With ``REPRO_SANITIZE=1`` ``query_batch`` and the
``frontier = "device"`` flush run under ``sanitize.guard``, which turns any
other sync on a CUDA device into a ``SanitizerError``, and every flush ends
with ``sanitize.scan_tables`` over the published tables.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
import zipfile
import zlib
from collections import OrderedDict
from typing import Iterator

import numpy as np
import torch

from repro_torch import trace
from repro_torch.analysis import sanitize
from repro_torch.core.bngraph import BNGraph
from repro_torch.core.construct import build_knn_tables, tables_to_index
from repro_torch.core.errors import (
    ArtifactError,
    EngineConfigError,
    EpochError,
    QueryError,
    StagedUpdateError,
)
from repro_torch.core.index import PAD_ID, KNNIndex
from repro_torch.core.journal import UpdateJournal
from repro_torch.core.updates import insert_affected_set
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

_FORMAT = "repro-knn-index"
# v2 added shard meta; v3 adds the content checksum. Load accepts v1/v2
# artifacts unchanged (no checksum to verify) and refuses versions > 3.
_FORMAT_VERSION = 3
_MAX_REPAIR_ROUNDS = 256
_INF = float("inf")


def _tables_checksum(ids: np.ndarray, dists: np.ndarray, objects: np.ndarray) -> int:
    """Content checksum over the logical artifact payload (order matters)."""
    crc = zlib.crc32(np.ascontiguousarray(ids).tobytes())
    crc = zlib.crc32(np.ascontiguousarray(dists).tobytes(), crc)
    return zlib.crc32(np.ascontiguousarray(objects).tobytes(), crc)


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


# the frontier state's source columns are padded to a multiple of this
_FRONTIER_COLS = 4


def _pow2_pad(x: int, lo: int = 8) -> int:
    """Next power of two >= x (>= lo)."""
    return max(lo, 1 << (max(1, x) - 1).bit_length())


class EngineCore:
    """Layout-independent serving core: the staged queue and its coalescing,
    query bookkeeping, the flush contract (delete scan -> checkIns frontier
    -> fused purge+merge -> breadth-first repair -> atomic publish), epochs
    and the stats surface.

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
    * ``_table_kth()``: the (n,) k-th-distance column (float64 host array),
      read only by the ``frontier = "host"`` baseline pipeline.
    * ``to_index()``: readback into the host ``KNNIndex`` view.

    and the flush's two round loops, each run to its fixpoint:

    * ``_insert_frontier(inserts) -> (rows, cand_ids, cand_d, rounds)``:
      Algorithm 4's checkIns for ALL staged inserts at once, as
      pruned-relaxation rounds against the pre-update k-th distances: the
      affected rows (sorted) and their compacted (object, exact distance)
      candidate lists, host arrays or device tensors, in the layout of
      ``_insert_frontier_host`` (the fixpoint is schedule-independent).
    * ``_repair(rows) -> rounds``: Jacobi re-merges of the purged rows
      (Algorithm 5's processDel, breadth-first).

    Both walk the JAX engine's rounds, parts and order: ``QueryEngine``
    builds each round's receiver sets on the device, ``ShardedQueryEngine``
    on the host (``repro_torch.core.sharded``).
    """

    def __init__(self, k: int, objects, *, bn: BNGraph | None, use_kernel: bool):
        # subclasses set ``self.n`` (and their tables) before calling super()
        self.k = int(k)
        self.use_kernel = bool(use_kernel)
        self.bn = bn
        self.frontier = "device"  # validated setter, see the property below
        self.halo = "collective"  # validated setter, see the property below
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
        self._journal: UpdateJournal | None = None
        self._epochs = EpochStore(keep=2)
        self._epoch_stats: dict[int, dict] = {}
        self._publish_epoch(0)
        self._epoch_stats[0] = {"origin": "build"}

    @property
    def frontier(self) -> str:
        """Which checkIns pipeline ``flush_updates`` runs: ``"device"``
        (default) is the batched multi-source ``ops.frontier_relax_rows`` rounds;
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

    @property
    def halo(self) -> str:
        """How cross-shard rows move during the sharded engine's repair and
        frontier rounds: ``"collective"`` (default) serves each round's
        unique neighbour rows into one slab on the device
        (``repro_torch.core.sharded``); ``"host"`` replays the routed-gather
        halo through the host (the baseline and the collective path's
        bit-identity twin). Both produce identical tables; unknown modes
        raise. The scalar engine and the one-shard layout have no shard
        boundary to exchange across, so the setting is inert there."""
        return self._halo

    @halo.setter
    def halo(self, mode: str) -> None:
        if mode not in ("collective", "host"):
            raise EngineConfigError(f"halo must be 'collective' or 'host', got {mode!r}")
        self._halo = mode

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

    def _prepare_publish(self) -> None:
        """Last hook inside the flush's fallible region, right before the
        pre-swap checkpoint. A subclass that stages a layout change (the
        sharded engine's repartition-on-flush) re-lays the working tables
        here, so that the ``_publish_epoch`` after it makes the new tables and
        the new layout visible in one step; a failure in here still rolls back
        through ``_restore_tables``."""

    def _checkpoint(self, phase: str) -> None:
        """Fault-injection seam: no-op unless ``checkpoint_hook`` is set.

        A test installs a hook that raises (simulated kill-at-this-point) or
        sends queries (snapshot-isolation probes). Phases fired:
        ``post-journal-append``, ``mid-repair-round``, ``pre-swap``,
        ``post-swap``, and ``pre-repartition`` / ``mid-repartition`` when the
        sharded engine has a staged repartition riding the flush.
        """
        hook = self.checkpoint_hook
        if hook is not None:
            hook(self, phase)

    def attach_journal(self, journal) -> UpdateJournal:
        """Pair the engine with a write-ahead update journal.

        ``journal`` is an ``UpdateJournal`` or a path (opened/created). Any
        records already in the journal are first replayed through the staged
        path: flush at each commit marker, reproducing the original flush
        boundaries, so the tables
        land identical to the uncrashed engine's; then any uncommitted tail
        is staged and rolled forward as one final flush (which appends its
        own commit marker, making recovery idempotent). From then on every
        ``stage_*`` call appends + fsyncs its record before acknowledging,
        every flush commits an epoch marker, and ``save`` truncates the
        journal once the artifact embodies it.
        """
        if self._journal is not None:
            raise ArtifactError("engine already has a journal attached")
        if self._staged:
            raise ArtifactError(
                "attach_journal before staging updates: the "
                f"{len(self._staged)} already-staged ops predate the journal "
                "and would not be durable"
            )
        if isinstance(journal, (str, os.PathLike)):
            journal = UpdateJournal(journal)
        self._replay_journal(journal)
        self._journal = journal
        return journal

    def _replay_journal(self, journal: UpdateJournal) -> None:
        """Roll the journal forward through the staged path (see
        ``attach_journal``). Journaling is off while the committed segments
        replay (their records are already on disk) and on for the tail's
        roll-forward flush, so that its commit marker is appended."""
        records = journal.replay()
        tail = False
        for rec in records:
            if rec[0] == "commit":
                self.flush_updates()
                self._epoch_stats[self.epoch]["origin"] = "recovery"
                tail = False
            elif rec[0] == "ins":
                self.stage_insert(rec[1])
                tail = True
            elif rec[0] == "del":
                self.stage_delete(rec[1])
                tail = True
            else:  # ("mov", u, v)
                self.stage_move(rec[1], rec[2])
                tail = True
        if tail:
            self._journal = journal  # the tail flush commits its marker
            try:
                self.flush_updates()
                self._epoch_stats[self.epoch]["origin"] = "recovery"
            finally:
                self._journal = None

    def _journal_op(self, op: tuple) -> None:
        """Write-ahead discipline: the record is on disk (fsync'd) before the
        stage call acknowledges. A kill right after this point is the
        ``post-journal-append`` chaos site: the op replays on reload even
        though the caller never saw the acknowledgement (the fsync completed,
        so applying it is the correct recovery)."""
        if self._journal is not None:
            self._journal.append_op(op)
            self._checkpoint("post-journal-append")

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
        with trace.span("repro_torch.query_batch"):
            us = np.asarray(us, dtype=np.int32)
            if us.ndim != 1:
                raise QueryError(f"queries must be a 1-D vertex array, got {us.shape}")
            epoch_r, snap = self._epochs.resolve(epoch)
            with sanitize.guard("query"):
                ks, width = self._ks_array(us.shape[0], k)
                with trace.span("repro_torch.gather_batch"):
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
        self._journal_op(("ins", u))
        self._pending.add(u)
        self._staged.append(("ins", u))
        return len(self._staged)

    def stage_delete(self, u: int) -> int:
        """Queue an object deletion; returns the staged-queue depth."""
        u = self._check_vertex(u)
        if u not in self._pending:
            raise StagedUpdateError(f"object {u} absent (or staged for delete)")
        self._journal_op(("del", u))
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
        self._journal_op(("mov", u, v))
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
        degree d is fully described by the first d columns; a frontier or
        repair part then runs on the (n+1, t) column slice of its width
        bucket t (``_bucket_widths``) instead of the global tau'. The padded
        host tables are built once per BNGraph; the per-width device slices
        are cached per engine (``_nbr_slice``).
        """
        if self._nbr_ids is None:
            packed = self.bn.bns_packed()
            self._nbr_ids = packed.ids
            self._nbr_w = packed.w
            self._nbr_deg = packed.deg
            self._nbr_indptr = packed.indptr
            self._nbr_indices = packed.indices

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """The explicit host -> device crossing of the guarded paths: the one
        place (with ``_readback``) that may sync under ``sanitize.guard``,
        counted as ``h2d`` and in ``h2d_bytes`` (``sanitize.upload``)."""
        return sanitize.upload(x, self.device)

    def _readback(self, x: torch.Tensor) -> np.ndarray:
        """The explicit device -> host crossing of the guarded paths, counted
        as ``d2h`` and in ``d2h_bytes``: ``x`` as a numpy array."""
        with sanitize.explicit("d2h"):
            out = x.cpu().numpy()
        trace.count("d2h_bytes", out.nbytes)
        return out

    def _nbr_slice(self, t: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Device (n+1, t) adjacency slice for one width bucket, cached."""
        if t not in self._nbr_by_t:
            self._nbr_by_t[t] = (
                self._upload(self._nbr_ids[:, :t]),
                self._upload(self._nbr_w[:, :t]),
            )
        return self._nbr_by_t[t]

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

    def _insert_frontier(
        self, inserts: list[int]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        raise NotImplementedError

    def _repair(self, rows: np.ndarray) -> int:
        raise NotImplementedError

    def _bucket_widths(self) -> list[int]:
        """The width buckets a round's rows are split by: 8, 32 and 128
        where they are below tau', then tau' (the JAX engine's)."""
        cap = self._nbr_ids.shape[1]
        return [b for b in (8, 32, 128) if b < cap] + [cap]

    def _place_candidates(self, rows: np.ndarray, frows: np.ndarray, fc_ids, fc_d):
        """The purge + merge batch's (len(rows), P) candidates: the frontier's
        lists at their rows of the sorted ``rows`` (``frows`` is a subset),
        (-1, +inf) at every other row; device tensors where the frontier left
        its lists on the device."""
        if frows.size == rows.size:
            return fc_ids, fc_d
        p = fc_ids.shape[1] if frows.size else 1
        pos = np.searchsorted(rows, frows)
        if isinstance(fc_ids, torch.Tensor):
            cand_ids = torch.full((len(rows), p), -1, dtype=torch.int32, device=fc_ids.device)
            cand_d = torch.full((len(rows), p), _INF, dtype=torch.float32, device=fc_ids.device)
            at = self._upload(pos.astype(np.int32)).long()
            cand_ids[at] = fc_ids
            cand_d[at] = fc_d
            return cand_ids, cand_d
        cand_ids = np.full((len(rows), p), -1, np.int32)
        cand_d = np.full((len(rows), p), np.inf, np.float32)
        if frows.size:
            cand_ids[pos] = fc_ids
            cand_d[pos] = fc_d
        return cand_ids, cand_d

    def _insert_frontier_host(  # port-lint: disable=PT001(the unguarded baseline: flush_updates guards the device frontier only)
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
        with trace.span("repro_torch.flush_updates"):
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
            # Sanitizer rail: the device flush pipeline runs under the sync guard
            # (every crossing through _upload / _readback); the "host" frontier
            # is the measured host baseline, exempt by definition.
            flush_guard = (
                sanitize.guard("flush") if self._frontier == "device" else contextlib.nullcontext()
            )
            try:
                with flush_guard:
                    # -- delete side: which rows name a deleted object (device scan) --
                    purged_rows = np.empty(0, np.int32)
                    with trace.span("repro_torch.flush.delete_scan"):
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
                    with trace.span("repro_torch.flush.frontier"):
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
                        with trace.span("repro_torch.flush.purge_merge"):
                            rows = np.union1d(purged_rows, frows).astype(np.int32)
                            cand_ids, cand_d = self._place_candidates(rows, frows, fc_ids, fc_d)
                            self._purge_merge(rows, deletes, cand_ids, cand_d)
                        t_purge = time.perf_counter() - t0
                        # -- breadth-first repair of the deletion holes --
                        if purged_rows.size:
                            t0 = time.perf_counter()
                            with trace.span("repro_torch.flush.repair"):
                                rounds = self._repair(purged_rows)
                            t_repair = time.perf_counter() - t0
                    # staged layout changes (repartition-on-flush) ride the same
                    # epoch: the hook re-lays the working tables, so the publish below
                    # swaps tables and layout in one step
                    self._prepare_publish()
                    self._checkpoint("pre-swap")
            except BaseException:
                self._restore_tables(base)
                self._stats["flushes_failed"] += 1
                raise

            # -- atomic swap: publish epoch e+1, commit the journal segment --
            self._objects = set(self._pending)
            self._staged.clear()
            new_epoch = self.epoch + 1
            self._publish_epoch(new_epoch)
            if self._journal is not None:
                self._journal.commit(new_epoch)
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
            trace.count("frontier_rounds", f_rounds)
            trace.count("repair_rounds", rounds)
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
            if sanitize.enabled():
                ids_h, d_h = self._host_tables()
                sanitize.scan_tables(ids_h, d_h, self.n, context=f"flush -> epoch {new_epoch}")
            return result

    # ------------------------------------------------------------------
    # persistence / stats
    # ------------------------------------------------------------------

    def _save_meta(self) -> dict:
        """Layout meta merged into the artifact's meta record."""
        return {"shards": 1}

    def save(self, path) -> None:
        """Write the index artifact: one npz shared by build and serving.

        Saving with a non-empty staged queue raises ``ArtifactError`` (rather
        than silently flushing): staged updates are invisible to queries, so
        an implicit flush would make the saved artifact disagree with what
        the engine was serving at save time. Call ``flush_updates()`` first;
        the tables are then exactly the flushed state and round-trip
        bit-identically through ``load``.

        The stored tables are the logical (n, k) layout in vertex order (the
        dummy row stripped), int32 ids and float32 distances, with the sorted
        int32 object set and a meta record carrying the format version and a
        content checksum over (ids, dists, objects) that ``load_artifact``
        verifies. The keys, types and meta are the JAX package's.

        If a journal is attached it is truncated AFTER the artifact is
        written: the artifact now embodies every committed record (the staged
        queue is empty here), so the journal restarts empty.
        """
        if self._staged:
            raise ArtifactError("flush_updates() before save(): staged updates pending")
        ids, dists = self._host_tables()
        objects = self.objects
        meta = {
            "format": _FORMAT,
            "version": _FORMAT_VERSION,
            "n": self.n,
            "k": self.k,
            "epoch": self.epoch,
            "checksum": _tables_checksum(ids, dists, objects),
            **self._save_meta(),
        }
        np.savez_compressed(
            path,
            ids=ids,
            dists=dists,
            k=np.int64(self.k),
            objects=objects,
            meta=np.bytes_(json.dumps(meta).encode()),
        )
        if self._journal is not None:
            self._journal.truncate()

    def _extra_stats(self) -> dict:
        """Layout counters merged into ``stats()``."""
        return {}

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
            **self._extra_stats(),
            **self._stats,
        }


def load_artifact(path) -> tuple[np.ndarray, np.ndarray, int, np.ndarray, dict]:
    """Read a ``save`` / ``knn_build --out`` npz: (ids, dists, k, objects, meta).

    Accepts the pre-engine ``knn_build`` npz too (no object set stored): M is
    recovered as the distance-0 entries, since every object is its own 0-th
    nearest neighbour, so exactly the objects appear at distance 0.

    Raises ``ArtifactError`` on a truncated or otherwise unreadable npz, on a
    schema version newer than this code (refusing beats misreading fields
    that did not exist yet) and on a content checksum that no longer matches
    the stored tables. v1/v2 artifacts carry no checksum and load unverified.
    """
    try:
        with np.load(path) as z:
            ids = z["ids"]
            dists = z["dists"]
            k = int(z["k"])
            if "objects" in z.files:
                objects = z["objects"]
            else:
                objects = np.unique(ids[dists == 0.0])
                objects = objects[objects >= 0]
            meta = json.loads(bytes(z["meta"])) if "meta" in z.files else {}
    except (OSError, ValueError, EOFError, KeyError, zlib.error, zipfile.BadZipFile) as e:
        raise ArtifactError(f"{path}: truncated or corrupt artifact ({e})") from e
    version = int(meta.get("version", 1))
    if version > _FORMAT_VERSION:
        raise ArtifactError(
            f"{path}: artifact schema version {version} is newer than this "
            f"code understands (max {_FORMAT_VERSION}); refusing to guess"
        )
    if "checksum" in meta:
        got = _tables_checksum(ids, dists, objects)
        if got != int(meta["checksum"]):
            raise ArtifactError(
                f"{path}: content checksum mismatch "
                f"(stored {meta['checksum']}, computed {got}): the file is "
                f"corrupt; rebuild or restore from a good copy"
            )
    return ids, dists, k, objects, meta


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
        self._bucket_of: torch.Tensor | None = None  # see _receiver_tables
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

    @classmethod
    def load(
        cls, path, *, bn: BNGraph | None = None, device="cuda", use_kernel: bool = True,
        journal=None,
    ) -> "QueryEngine":
        """Load a ``save`` / ``knn_build --out`` artifact (either package's).
        ``bn`` enables updates.

        ``journal`` (path or ``UpdateJournal``) attaches a write-ahead journal
        and REPLAYS it first: updates journaled after the artifact was saved
        (committed flushes and the uncommitted tail) are rolled forward
        through the staged path, recovering exactly the tables a killed
        process was serving (see ``attach_journal``). Requires ``bn`` when
        the journal is non-empty.
        """
        ids, dists, k, objects, _ = load_artifact(path)
        eng = cls.from_tables(ids, dists, k, objects, bn=bn, device=device, use_kernel=use_kernel)
        if journal is not None:
            eng.attach_journal(journal)
        return eng

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

    def _gather_batch(self, us: np.ndarray, ks: np.ndarray, snap: tuple, epoch: int):
        # the JAX engine's gather semantics for any id: a negative id wraps
        # once from the end of the (n+1)-row table (-1 is the dummy row), then
        # everything clamps into [0, n]; n reads the dummy row (-1, +inf)
        n = self.n
        vs = self._upload(us).long()
        vs = torch.where(vs < 0, vs + n + 1, vs).clamp_(0, n)
        return ops.serve_gather(snap[0], snap[1], vs, self._upload(ks))

    def _scan_delete_rows(self, deletes: list[int]) -> np.ndarray:
        del_arr = self._upload(np.asarray(deletes, np.int32))
        hit = ops.rows_containing(self._vk_ids, del_arr)
        return np.flatnonzero(self._readback(hit)).astype(np.int32)

    def _table_kth(self) -> np.ndarray:
        return self._readback(self._vk_d[: self.n, -1]).astype(np.float64)

    def _host_tables(self) -> tuple[np.ndarray, np.ndarray]:
        return self._readback(self._vk_ids[: self.n]), self._readback(self._vk_d[: self.n])

    def _purge_merge(self, rows, deletes, cand_ids, cand_d) -> None:
        self._own_tables()
        # an empty delete list still needs one id to test against: n is never
        # an object id, so never a hit
        del_arr = np.asarray(deletes if deletes else [self.n], np.int32)
        cand_ids, cand_d = (x if isinstance(x, torch.Tensor) else self._upload(x)
                            for x in (cand_ids, cand_d))
        ops.rows_purge_merge(
            self._vk_ids, self._vk_d, self._upload(rows), self._upload(del_arr),
            cand_ids, cand_d, self.k, use_kernel=self.use_kernel,
        )

    # the flush's round loops walk the JAX engine's rounds, parts and order
    # (the host form of its loops is the sharded engine's, in
    # ``repro_torch.core.sharded``): each round's receiver set is built on
    # the card from the parts that ran and the changed masks they left
    # there, and split by width bucket there. Per round one readback of the
    # bucket sizes (at most 4 int32) crosses; no part goes up, no mask comes
    # back. A part runs at its bucket's width (8, 32, 128, tau'), where the
    # JAX engine gives a last-bucket part 512 if tau' > 512 and none of its
    # rows is wider: K2 and K3 skip padded slots, so only the slice they
    # read differs.

    def _receiver_tables(self) -> None:
        """Bind the receiver split's device tables once per engine: each
        vertex's width bucket (degree-0 rows, the dummy row n and
        the spare slot n+1 in none, index ``len(widths)``), the bucket
        indices and the vertex ids 0..n+1."""
        if self._bucket_of is None:
            self._nbr_tables()
            widths = self._bucket_widths()
            deg = np.append(self._nbr_deg, 0)  # rows 0..n, then the spare slot
            # deg in (widths[i-1], widths[i]] -> bucket i
            bucket = np.where(deg > 0, np.searchsorted(widths, deg), len(widths))
            self._bucket_of = self._upload(bucket.astype(np.int8)).long()
            self._bucket_ids = torch.arange(len(widths), device=self.device)
            self._vertex_ids = torch.arange(self.n + 2, dtype=torch.int32, device=self.device)

    def _vertex_mask(self) -> torch.Tensor:
        """An empty (n+2,) vertex mask: rows 0..n, and n+1, the spare slot
        that masked-out ids are aimed at."""
        return torch.zeros(self.n + 2, dtype=torch.bool, device=self.device)

    def _mark(self, mask: torch.Tensor, ids: torch.Tensor, keep=None) -> None:
        """Set ``mask`` in place at the vertex ids ``ids`` (any shape; -1 pads
        skipped) where ``keep`` holds: a fixed-size index, whatever is kept."""
        ok = ids >= 0 if keep is None else keep & (ids >= 0)
        mask.index_fill_(0, torch.where(ok, ids, self.n + 1).reshape(-1).long(), True)

    def _receiver_parts(self, mask: torch.Tensor) -> list[tuple[int, torch.Tensor]]:
        """The vertices set in ``mask`` split by width bucket, on the card:
        (width, rows) for each non-empty bucket, in bucket order,
        ascending ids within one, rows a device int32 tensor. The bucket
        sizes are read back (the round's one crossing), then each receiver
        goes to its rank in that order, a ``cumsum`` over the (buckets,
        n+2) membership flattened bucket-major, by a ``scatter`` into a
        buffer of the size read back; every other vertex goes to the spare
        slot past it. (One flat scan: a scan along each of the few bucket
        rows runs a row to a block.)

        A receiver is a BNS neighbour of a row that ran in a part, and BN
        adjacency is symmetric, so it has degree >= 1 and a part: the sizes
        read back are the host set's size, which decides termination."""
        nb = self._bucket_ids.shape[0]
        key = torch.where(mask, self._bucket_of, nb)
        hot = key == self._bucket_ids[:, None]  # (buckets, n+2)
        count = hot.sum(dim=1, dtype=torch.int32)
        sizes = self._readback(count)
        total = int(sizes.sum())
        if total == 0:
            return []
        rank = hot.reshape(-1).cumsum(0, dtype=torch.int32)
        at = key.clamp(max=nb - 1) * (self.n + 2) + self._vertex_ids
        slot = torch.where(key < nb, rank[at] - 1, total)
        rows = torch.empty(total + 1, dtype=torch.int32, device=self.device)
        rows.scatter_(0, slot.long(), self._vertex_ids)
        parts = rows[:total].split([int(s) for s in sizes])
        return [(t, part) for t, part in zip(self._bucket_widths(), parts) if part.numel()]

    def _next_receivers(self, ran, *, narrow=None, touched=None):
        """The next round's parts from the round that ran, ``ran`` = (width,
        rows, changed mask) a part: the BNS neighbours of the changed rows
        (read from each part's bucket table: ``lo_ids[changed] ∪
        hi_ids[changed]``, the push form, which asks nothing of the
        adjacency's symmetry), ANDed with the ``narrow`` mask where one is
        given, split by ``_receiver_parts``; the changed rows are also set
        in ``touched`` where one is given. Counts the set's rows as
        ``receiver_rows``."""
        receivers = self._vertex_mask()
        for t, part, changed in ran:
            self._mark(receivers, self._nbr_slice(t)[0][part.long()], changed[:, None])
            if touched is not None:
                self._mark(touched, part, changed)
        parts = self._receiver_parts(receivers if narrow is None else receivers & narrow)
        trace.count("receiver_rows", sum(part.numel() for _, part in parts))
        return parts

    def _repair(self, rows: np.ndarray) -> int:
        """The JAX engine's repair rounds, parts and order, with each round's
        receivers built on the card: the BNS neighbours of the rows that
        changed, narrowed to the purged rows' mask. Round 1 re-merges every
        purged row; a later round only those a changed row neighbours (BN
        adjacency is symmetric, so no other row can improve)."""
        self._receiver_tables()
        purged = self._vertex_mask()
        self._mark(purged, self._upload(rows))
        parts = self._receiver_parts(purged)
        active = rows.size > 0
        rounds = 0
        while active and rounds < _MAX_REPAIR_ROUNDS:
            ran = [(t, part, self._repair_part(part, t)) for t, part in parts]
            rounds += 1
            self._checkpoint("mid-repair-round")
            parts = self._next_receivers(ran, narrow=purged)
            active = bool(parts)
        if active:
            raise RuntimeError(
                f"delete repair did not reach a fixpoint in {_MAX_REPAIR_ROUNDS} rounds"
            )
        return rounds

    def _repair_part(self, part: torch.Tensor, t: int) -> torch.Tensor:
        """One repair round over device rows ``part`` of width bucket ``t``;
        the changed mask stays on the device."""
        self._own_tables()
        nbr_tab, w_tab = self._nbr_slice(t)
        return _repair_round(nbr_tab, w_tab, part, self._vk_ids, self._vk_d, self.use_kernel)

    def _insert_frontier(
        self, inserts: list[int]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """The JAX engine's frontier rounds, parts and order, with each
        round's receivers built on the card (the BNS neighbours of the rows
        that changed; round 1: of the sources) and the touched rows kept in
        a device mask, read back once after convergence. Round r relaxes
        the receivers against the live k-th-distance column, the checkIns
        test ``d < kth[w]``."""
        self._receiver_tables()
        src = np.asarray(inserts, np.int32)
        state = self._frontier_init(src)
        touched = self._vertex_mask()
        # round 1's receivers: the sources' neighbours, as if the sources had
        # run as one part of the widest bucket and all changed; a padded
        # source column reads the dummy row n, which has no neighbours
        src_rows = torch.where(self._fsrc >= 0, self._fsrc, self.n)
        parts = self._next_receivers([(self._bucket_widths()[-1], src_rows, self._fsrc >= 0)],
                                     touched=touched)
        active = src.size > 0
        rounds = 0
        while active and rounds < _MAX_REPAIR_ROUNDS:
            ran = []
            for t, part in parts:
                self._fwidth = t
                state, changed = self._frontier_part(state, part)
                ran.append((t, part, changed))
            rounds += 1
            parts = self._next_receivers(ran, touched=touched)
            active = bool(parts)
        if active:
            raise RuntimeError(
                f"checkIns frontier did not reach a fixpoint in {_MAX_REPAIR_ROUNDS} rounds"
            )
        rows = np.flatnonzero(self._readback(touched[: self.n])).astype(np.int32)
        trace.count("rows_touched", rows.size)
        return (*self._frontier_candidates(state, rows, src), rounds)

    # frontier provider: the multi-source tentative distance state is one
    # (n+1, B) device matrix, private to the flush and updated in place
    # between rounds; the pruning column is sliced off the live table once
    # per flush (the tables do not change while the frontier runs), so no
    # kth value ever crosses the host boundary.

    def _frontier_init(self, src: np.ndarray) -> torch.Tensor:
        # source columns padded to a multiple of 4 (-1 pads, +inf throughout),
        # so that K3 may read its rows four columns at a time; the JAX engine
        # pads to a power of two for its compile cache
        b = -(-len(src) // _FRONTIER_COLS) * _FRONTIER_COLS
        self._fsrc = self._upload(np.pad(np.asarray(src, np.int32), (0, b - len(src)),
                                         constant_values=-1))
        self._fkth = self._vk_d[:, -1].contiguous()
        self._fcols = len(src)
        return _frontier_init_prog(self._fsrc, self._vk_ids.shape[0])

    def _frontier_part(self, state, part: torch.Tensor):
        # device rows of one width bucket, ``self._fwidth``, which the round
        # loop names before the call: knnbench/tests/test_knnbench_fleet.py
        # wraps this method as ``part(self, state, rows)``
        nbr_tab, w_tab = self._nbr_slice(self._fwidth)
        trace.count("k3_bytes", _k3_least_bytes(nbr_tab, part, self._fcols))
        changed = _frontier_round(
            nbr_tab, w_tab, part, state, self._fkth, self._fsrc, self.use_kernel,
        )
        return state, changed

    def _frontier_candidates(self, state, rows: np.ndarray, src: np.ndarray):
        # the affected test and the compaction stay on the device: only each
        # touched row's count of affected sources comes back (which rows keep
        # a list, and the width), never the (R, B) tile
        b = len(src)
        aff, d = _frontier_affected(self._upload(rows), state, self._fkth, self._fsrc)
        return self._compact_on_device(rows, aff[:, :b], d[:, :b], self._fsrc[:b])

    def _compact_on_device(self, rows: np.ndarray, aff, d, src):
        """``sharded.compact_candidates`` of the device tile (``aff``,
        ``d``) with source ids ``src``: the kept rows on the host, their
        lists on the device."""
        counts = self._readback(aff.sum(dim=1, dtype=torch.int32))
        keep = np.flatnonzero(counts).astype(np.int32)
        if keep.size == 0:
            return rows[keep], np.empty((0, 1), np.int32), np.empty((0, 1), np.float32)
        p = _pow2_pad(int(counts.max()), lo=4)
        cand_ids, cand_d = _compact_rows(aff, d, src, self._upload(keep), p)
        return rows[keep], cand_ids, cand_d


def _frontier_init_prog(src: torch.Tensor, n1: int) -> torch.Tensor:
    """Allocate the (n+1, B) multi-source tentative-distance matrix: +inf
    everywhere except 0 at (src[i], i). Padded source columns (src = -1)
    park their +inf on the dummy row, so they stay +inf throughout."""
    b = src.shape[0]
    dist = torch.full((n1, b), _INF, dtype=torch.float32, device=src.device)
    real = src >= 0
    dist[torch.where(real, src, n1 - 1).long(), torch.arange(b, device=src.device)] = (
        torch.where(real, 0.0, _INF))
    return dist


def _frontier_round(nbr_tab, w_tab, rows, dist, kth, src, use_kernel: bool) -> torch.Tensor:
    """One frontier round: ``ops.frontier_relax_rows`` relaxes the receivers
    against the k-th column, reading their rows of the bucket tables, and
    gives the changed mask that narrows the next round's receiver set; then
    the new rows are stored into ``dist`` in place. Every relaxation read
    saw the pre-round ``dist``."""
    new, changed = ops.frontier_relax_rows(
        nbr_tab, w_tab, rows, dist, kth, src, use_kernel=use_kernel
    )
    dist[rows.long()] = new
    return changed


def _frontier_affected(rows, dist, kth, src):
    """Affected test for the touched rows after convergence: checkIns against
    the k-th column, plus the source rows themselves (Algorithm 4 admits the
    inserted object unconditionally). Returns the (R, B) mask and the distance
    tile, on the device."""
    idx = rows.long()
    d = dist[idx]
    aff = (d < kth[idx][:, None]) | (rows[:, None] == src[None, :])
    return aff, d


def _compact_rows(aff, d, src, keep, p: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows ``keep`` of the (R, B) affected mask ``aff`` and distance tile
    ``d`` as (len(keep), p) candidate lists on their device: each row's
    affected columns first, in column (source) order, as (src[column],
    distance), then (-1, +inf); ``sharded.compact_candidates``' layout.
    An affected column goes to its rank among its row's affected columns,
    every other one to a spare column p, which is cut off."""
    idx = keep.long()
    aff, d = aff[idx], d[idx]
    r = aff.shape[0]
    col = torch.where(aff, aff.cumsum(dim=1) - 1, p)
    cand_ids = torch.full((r, p + 1), -1, dtype=torch.int32, device=aff.device)
    cand_ids.scatter_(1, col, src.expand(r, -1))
    cand_d = torch.full((r, p + 1), _INF, dtype=torch.float32, device=aff.device)
    cand_d.scatter_(1, col, d)
    return cand_ids[:, :p].contiguous(), cand_d[:, :p].contiguous()


def _k3_least_bytes(nbr_tab, rows, b: int) -> torch.Tensor:
    """The least bytes of one K3 launch over receivers ``rows`` with ``b``
    source columns, whatever implements it: each receiver's live neighbour
    slots once with their weights (8 B a slot), each distinct neighbour's row
    of the state once and each receiver's row of the result once (4 B a
    column). A device scalar, so counting never waits for the device."""
    n1 = nbr_tab.shape[0]
    nb = nbr_tab[rows.long()].long()
    live = nb >= 0
    seen = torch.zeros(n1 + 1, dtype=torch.bool, device=nb.device)
    seen.index_fill_(0, torch.where(live, nb, n1).reshape(-1), True)
    return 8 * live.sum() + 4 * b * (seen[:n1].sum() + rows.shape[0])


def _repair_round(nbr_tab, w_tab, rows, vk_ids, vk_d, use_kernel: bool) -> torch.Tensor:
    """One Jacobi repair round, in place on (vk_ids, vk_d): every row in
    ``rows`` re-merges its own entries (extras tables = the live tables
    themselves) with its bridge neighbours' rows, all reading the pre-round
    tables (tile merge, then compare, then scatter). Returns the
    per-row changed mask the caller uses to narrow the next round."""
    k = vk_ids.shape[1]
    idx = rows.long()
    new_ids, new_d = ops.sweep_merge(
        nbr_tab[idx], rows, w_tab[idx], vk_ids, vk_d, vk_ids, vk_d, k, use_kernel=use_kernel,
    )
    changed = ((new_ids != vk_ids[idx]) | (new_d != vk_d[idx])).any(dim=1)
    vk_ids[idx] = new_ids
    vk_d[idx] = new_d
    return changed
