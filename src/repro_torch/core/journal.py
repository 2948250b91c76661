"""Write-ahead update journal: durability for the staged-update queue.

The serving engine acknowledges a staged update (``stage_insert`` /
``stage_delete`` / ``stage_move``) the moment the call returns — from that
point the update MUST survive a process kill, even though it is not yet
applied to the tables and the artifact on disk still holds an older epoch.
``UpdateJournal`` is the standard WAL answer, sized to this system's tiny
record vocabulary:

* every acknowledged staged op is appended as one length+checksum framed
  record and fsync'd BEFORE the stage call returns;
* ``flush_updates`` appends a ``commit`` marker carrying the new epoch
  number after the table swap, so the journal records exactly which ops
  were batched into which flush (replay reproduces the same flush
  boundaries, which is what makes recovered tables byte-identical to an
  uncrashed engine's — the flush pipeline is deterministic per batch);
* ``replay()`` parses the record stream back into staged ops and commit
  markers. A torn tail — a partial frame from a kill mid-``write``, or
  garbage from a corrupted sector — fails its length/CRC check; the
  journal truncates the file back to the last whole record and reports
  what it dropped, instead of crashing or replaying garbage. Only records
  whose fsync never completed can be dropped this way, i.e. ops that were
  never acknowledged;
* the engine truncates the journal when the artifact is saved
  (``EngineCore.save``): at that point the artifact embodies every
  committed record, so the journal restarts empty. A flush commit alone
  does NOT truncate — the artifact on disk still predates the flush, and
  truncating there would lose the only durable copy of those updates.

Framing
-------
``8-byte magic | record*`` where each record is::

    u32 payload_len | u32 crc32(payload) | payload

and the payload is one tag byte plus little-endian int64 fields::

    b"I" u           stage_insert(u)
    b"D" u           stage_delete(u)
    b"M" u v         stage_move(u, v)
    b"C" epoch       flush committed -> epoch

This is the JAX package's format byte for byte (same magic, framing and
CRC), so a journal written by either package replays in the other.

``load``-time recovery (see ``QueryEngine.load`` / ``attach_journal``):
replay every record through the engine's staged path, calling
``flush_updates`` at each commit marker; a trailing run of ops with no
marker (the crash interrupted or preceded their flush) is staged and
rolled forward as one final flush — the tables land exactly where the
crashed process was headed, because the index is a pure function of the
object set and the flush pipeline is deterministic per batch.
"""
from __future__ import annotations

import os
import struct
import zlib

from repro_torch.core.errors import JournalError

_MAGIC = b"RKNNWAL1"
_FRAME = struct.Struct("<II")  # payload length, crc32(payload)
_I64 = struct.Struct("<q")
_I64x2 = struct.Struct("<qq")
# a record payload is 9 or 17 bytes today; anything bigger than this is
# garbage masquerading as a length field, not a future format extension
_MAX_PAYLOAD = 1 << 16

Record = tuple  # ("ins", u) | ("del", u) | ("mov", u, v) | ("commit", epoch)


class UpdateJournal:
    """Append-only fsync'd journal of staged ops + flush commit markers."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self.dropped_bytes = 0  # torn/garbage tail bytes discarded by replay
        size = os.path.getsize(self.path) if os.path.exists(self.path) else 0
        # A file shorter than the magic can only be a kill between creation
        # and the magic fsync: zero records were ever acknowledged through
        # it, so recover it as a fresh journal instead of refusing to open.
        fresh = size < len(_MAGIC)
        self._f = open(self.path, "a+b")
        if fresh:
            self._f.truncate(0)
            self._f.write(_MAGIC)
            self._sync()
        else:
            self._f.seek(0)
            head = self._f.read(len(_MAGIC))
            if head != _MAGIC:
                self._f.close()
                raise JournalError(
                    f"{self.path} is not an update journal "
                    f"(bad magic {head!r}, expected {_MAGIC!r})"
                )

    # ------------------------------------------------------------------
    # writing
    # ------------------------------------------------------------------

    def _sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def _append(self, payload: bytes) -> None:
        self._f.write(_FRAME.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)
        self._sync()

    def append_op(self, op: Record) -> None:
        """Durably record one staged op BEFORE it is acknowledged."""
        kind = op[0]
        if kind == "ins":
            self._append(b"I" + _I64.pack(op[1]))
        elif kind == "del":
            self._append(b"D" + _I64.pack(op[1]))
        elif kind == "mov":
            self._append(b"M" + _I64x2.pack(op[1], op[2]))
        else:
            raise JournalError(f"unknown staged op kind {kind!r}")

    def commit(self, epoch: int) -> None:
        """Mark every op appended since the previous marker as flushed
        into ``epoch``. Written AFTER the in-memory table swap: a kill
        between swap and marker just re-runs that flush on replay."""
        self._append(b"C" + _I64.pack(int(epoch)))

    def truncate(self) -> None:
        """Reset to an empty journal (magic only). Correct only once the
        artifact on disk embodies every committed record — the engine
        calls this from ``save``, never from a flush."""
        self._f.truncate(len(_MAGIC))
        self._sync()

    # ------------------------------------------------------------------
    # reading / recovery
    # ------------------------------------------------------------------

    def replay(self) -> list[Record]:
        """Parse the journal back into ops + commit markers, in order.

        A torn or garbage tail (bad length, bad CRC, unknown tag, short
        frame) ends the parse at the last whole record: the file is
        truncated back to that point (so later appends never interleave
        with garbage) and the dropped byte count is recorded in
        ``self.dropped_bytes``. Corruption can only live in the tail —
        every earlier record was fsync'd before its op was acknowledged.
        ``dropped_bytes`` describes THIS replay only — it resets to 0 on
        entry so a clean replay never reports an earlier replay's tail.
        """
        self.dropped_bytes = 0
        self._f.seek(0)
        buf = self._f.read()
        out: list[Record] = []
        pos = len(_MAGIC)
        good = pos
        while pos < len(buf):
            if pos + _FRAME.size > len(buf):
                break  # torn frame header
            length, crc = _FRAME.unpack_from(buf, pos)
            start = pos + _FRAME.size
            if length > _MAX_PAYLOAD or start + length > len(buf):
                break  # garbage length / torn payload
            payload = buf[start : start + length]
            if zlib.crc32(payload) != crc:
                break  # bit rot or torn write inside the payload
            rec = self._decode(payload)
            if rec is None:
                break  # unknown tag: not ours, stop before it
            out.append(rec)
            pos = start + length
            good = pos
        if good < len(buf):
            self.dropped_bytes = len(buf) - good
            self._f.truncate(good)
            self._sync()
        return out

    @staticmethod
    def _decode(payload: bytes) -> Record | None:
        tag, body = payload[:1], payload[1:]
        try:
            if tag == b"I":
                return ("ins", _I64.unpack(body)[0])
            if tag == b"D":
                return ("del", _I64.unpack(body)[0])
            if tag == b"M":
                return ("mov", *_I64x2.unpack(body))
            if tag == b"C":
                return ("commit", _I64.unpack(body)[0])
        except struct.error:
            return None
        return None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "UpdateJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return f"UpdateJournal({self.path!r})"
