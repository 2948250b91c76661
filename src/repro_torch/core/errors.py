"""Typed error taxonomy for the kNN serving system.

Every failure mode the engine can surface to a caller is a subclass of
``RepError``, so ``except RepError`` catches exactly "this system rejected
the request / detected corruption" without also swallowing genuine bugs
(``TypeError``, ``AttributeError``, ...). Each subclass ALSO inherits the
builtin exception the pre-taxonomy code raised for that condition
(``ValueError`` for request validation, ``RuntimeError`` for state/
durability violations), so existing ``except ValueError`` call sites — and
the seed test suite's ``pytest.raises`` assertions — keep working unchanged.

The taxonomy, by layer:

* ``QueryError`` — a malformed query request: ``k`` exceeding the index's
  k, a per-query k vector of the wrong shape, a non-1-D query batch.
* ``StagedUpdateError`` — a staged update the engine must refuse:
  insert of a present object, delete of an absent one, a self-move, a
  vertex outside ``[0, n)``.
* ``EngineConfigError`` — an invalid engine configuration value, e.g. an
  unknown ``engine.frontier`` pipeline name.
* ``EpochError`` — an epoch request the retention policy cannot serve
  (already-evicted or never-published epoch, ``keep_epochs < 1``).
* ``ArtifactError`` — a persistence-layer violation: saving with staged
  updates pending, loading a truncated/corrupted npz, a content-checksum
  mismatch, a schema version newer than this code understands.
* ``JournalError`` — a write-ahead journal file that cannot be used at
  all (bad magic/header). Torn or garbage record *tails* are NOT errors:
  the journal truncates them cleanly on replay (crash recovery), so only
  a file that was never a journal raises.
* ``SanitizerError`` — a device-residency invariant violated at runtime,
  caught by the sanitizer rail (not ported yet): a host
  transfer on a guarded query/flush path, a compile-budget overrun, a
  NaN/negative-distance/corrupt-id table entry after a flush, or a hand-written
  kernel diverging from its host oracle under poisoned buffers.

Exported through the ``repro_torch.knn`` facade.
"""
from __future__ import annotations


class RepError(Exception):
    """Base class for every typed error this system raises."""


class QueryError(RepError, ValueError):
    """A query request the engine cannot serve (bad k / batch shape)."""


class StagedUpdateError(RepError, ValueError):
    """A staged object update that violates the object-set state."""


class EngineConfigError(RepError, ValueError):
    """An invalid engine configuration value (e.g. unknown pipeline name)."""


class EpochError(RepError, ValueError):
    """An epoch that is unknown, already evicted, or an invalid retention."""


class ArtifactError(RepError, RuntimeError):
    """A persistence violation: corrupt/stale artifact or unsafe save."""


class JournalError(ArtifactError):
    """A file that is not a usable write-ahead journal (bad magic/header)."""


class SanitizerError(RepError, RuntimeError):
    """A device-residency invariant violated at runtime (sanitizer rail)."""
