"""The port's artifacts and write-ahead journal (on the CPU), held against the
JAX package's.

Mirrors ``tests/core/test_artifacts.py`` and the scalar cases of
``tests/chaos/test_killpoints.py`` on the port's engine: corruption raises
the typed errors, torn journal tails recover, and a kill at every checkpoint
recovers to the tables of an uncrashed engine that took the same ops at the
same flush boundaries. Then across packages: an artifact or a journal written
by one package loads and recovers in the other. Tolerance: exact
(``array_equal`` on int32 ids and float32 distances; the recovered epoch and
object set equal too).
"""
import json
import os
import shutil

import numpy as np
import pytest

from repro import knn as jknn
from repro_torch import knn
from repro_torch.core.engine import _FORMAT_VERSION, load_artifact

PHASES = ["post-journal-append", "pre-swap", "mid-repair-round", "post-swap"]


class SimulatedKill(Exception):
    """Raised by the checkpoint hook to model the process dying there."""


def _setup(grid=8, mu=0.2, k=4, seed=0):
    g = knn.road_network(grid, grid, seed=seed)
    objects = knn.pick_objects(g.n, mu, seed=seed)
    return g, knn.build_bngraph(g), objects, k


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    g, bn, objects, k = _setup()
    eng = knn.build_engine(bn, objects, k, device="cpu")
    art = str(tmp_path_factory.mktemp("artifacts") / "idx.npz")
    eng.save(art)
    return g, bn, objects, eng, art


def _load(path, bn, journal=None):
    return knn.load_engine(path, bn=bn, device="cpu", journal=journal)


def _tables(eng):
    return eng._host_tables()  # (n, k) int32 ids, float32 dists, either package


def _assert_same(a, b):
    """Equal epoch, object set and tables (either package's engine)."""
    assert a.epoch == b.epoch
    np.testing.assert_array_equal(a.objects, b.objects)
    ai, ad = _tables(a)
    bi, bd = _tables(b)
    assert ai.dtype == bi.dtype == np.int32 and ad.dtype == bd.dtype == np.float32
    np.testing.assert_array_equal(ai, bi)
    np.testing.assert_array_equal(ad, bd)


def _stage_mix(eng, mset, seed, count=5):
    """Random net inserts/deletes plus one explicit move, so every flush has a
    purge set (the move's source) and the repair rounds always run."""
    knn.stage_random_updates(eng, mset, rng=seed, count=count)
    u = sorted(mset)[0]
    v = next(w for w in range(eng.n) if w not in mset)
    eng.stage_move(u, v)
    mset.discard(u)
    mset.add(v)


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------


def _rewrite(src, dst, mutate):
    """Round-trip the npz through a mutation of (arrays, meta)."""
    with np.load(src) as z:
        data = {f: z[f] for f in z.files}
    meta = json.loads(bytes(data["meta"]))
    mutate(data, meta)
    data["meta"] = np.bytes_(json.dumps(meta).encode())
    np.savez_compressed(dst, **data)


def _truncate(src, dst):
    raw = open(src, "rb").read()
    with open(dst, "wb") as f:
        f.write(raw[: len(raw) // 2])


def _flip_table_bit(data, meta):
    data["dists"] = data["dists"] + np.float32(1.0)  # tables change, checksum does not


def _future_version(data, meta):
    meta["version"] = _FORMAT_VERSION + 7


CORRUPTIONS = [
    ("truncated", _truncate, "truncated or corrupt"),
    ("checksum", lambda s, d: _rewrite(s, d, _flip_table_bit), "checksum mismatch"),
    ("version-skew", lambda s, d: _rewrite(s, d, _future_version), "schema version"),
]


@pytest.mark.parametrize("name,corrupt,msg", CORRUPTIONS, ids=[c[0] for c in CORRUPTIONS])
def test_corrupt_artifact_raises_typed_error(built, tmp_path, name, corrupt, msg):
    _, bn, _, _, art = built
    bad = str(tmp_path / f"{name}.npz")
    corrupt(art, bad)
    with pytest.raises(knn.ArtifactError, match=msg):
        _load(bad, bn)
    with pytest.raises(RuntimeError):  # the builtin the taxonomy keeps
        _load(bad, bn)
    # the JAX package refuses the same file with the same message
    with pytest.raises(jknn.ArtifactError, match=msg):
        jknn.load_engine(bad)


def test_save_load_round_trip_and_format(built):
    g, bn, objects, eng, art = built
    rec = _load(art, bn)
    _assert_same(rec, eng)
    ids, dists, k, objs, meta = load_artifact(art)
    assert (ids.dtype, dists.dtype, objs.dtype, k) == (np.int32, np.float32, np.int32, 4)
    assert set(meta) == {"format", "version", "n", "k", "epoch", "checksum", "shards"}
    assert (meta["format"], meta["version"], meta["n"], meta["shards"]) == (
        "repro-knn-index", 3, g.n, 1)
    with np.load(art) as z:
        assert sorted(z.files) == ["dists", "ids", "k", "meta", "objects"]
        assert z["k"].dtype == np.int64


def test_unversioned_legacy_artifact_still_loads(built, tmp_path):
    """v1/v2 artifacts carry no checksum: they load unverified."""
    g, bn, _, eng, art = built
    legacy = str(tmp_path / "legacy.npz")

    def strip(data, meta):
        meta.pop("checksum", None)
        meta["version"] = 1

    _rewrite(art, legacy, strip)
    _assert_same(_load(legacy, bn), eng)


def test_pre_engine_artifact_recovers_objects_from_distance_zero(built, tmp_path):
    g, bn, objects, eng, art = built
    old = str(tmp_path / "old.npz")
    with np.load(art) as z:
        np.savez_compressed(old, ids=z["ids"], dists=z["dists"], k=z["k"])
    _assert_same(_load(old, bn), eng)


def test_save_with_pending_queue_raises_artifact_error(built, tmp_path):
    g, bn, objects, _, art = built
    eng = _load(art, bn)
    eng.stage_insert(next(v for v in range(g.n) if v not in set(eng.objects.tolist())))
    with pytest.raises(knn.ArtifactError):
        eng.save(str(tmp_path / "nope.npz"))
    with pytest.raises(RuntimeError):
        eng.save(str(tmp_path / "nope.npz"))


def test_load_engine_defaults_to_cuda_and_raises_without_a_card(built):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    _, bn, _, _, art = built
    with pytest.raises(RuntimeError, match="no CUDA device"):
        knn.load_engine(art, bn=bn)


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------


def test_journal_torn_tail_truncated_and_recovered(built, tmp_path):
    g, bn, objects, _, art = built
    wal = str(tmp_path / "wal.bin")
    eng = _load(art, bn, journal=wal)
    mset = set(int(o) for o in objects)
    knn.stage_random_updates(eng, mset, rng=5, count=4)
    eng.flush_updates()
    knn.stage_random_updates(eng, mset, rng=6, count=3)
    good_size = os.path.getsize(wal)
    with open(wal, "ab") as f:  # torn frame: length promises more than exists
        f.write(b"\xff\x00\x00\x00\x12\x34\x56\x78partial")

    j = knn.UpdateJournal(wal)
    rec = _load(art, bn, journal=j)
    assert j.dropped_bytes > 0
    assert os.path.getsize(wal) >= good_size  # truncated back + tail commit
    eng.flush_updates()
    _assert_same(rec, eng)


def test_journal_second_replay_reports_no_drops(built, tmp_path):
    g, bn, objects, _, art = built
    wal = str(tmp_path / "wal.bin")
    eng = _load(art, bn, journal=wal)
    mset = set(int(o) for o in objects)
    knn.stage_random_updates(eng, mset, rng=8, count=3)
    with open(wal, "ab") as f:
        f.write(b"\x10\x00\x00\x00\xde\xad\xbe\xefshort")
    with knn.UpdateJournal(wal) as j:
        first = j.replay()
        assert j.dropped_bytes > 0
        assert [r[0] for r in first].count("commit") == 0 and len(first) == 3
        second = j.replay()
        assert second == first
        assert j.dropped_bytes == 0


def test_journal_bad_magic_raises(tmp_path):
    p = str(tmp_path / "notawal.bin")
    with open(p, "wb") as f:
        f.write(b"GARBAGE!and then some")
    with pytest.raises(knn.JournalError):
        knn.UpdateJournal(p)


def test_journal_truncates_on_save_not_on_flush(built, tmp_path):
    g, bn, objects, _, art = built
    wal = str(tmp_path / "wal.bin")
    eng = _load(art, bn, journal=wal)
    base = os.path.getsize(wal)
    mset = set(int(o) for o in objects)
    knn.stage_random_updates(eng, mset, rng=7, count=3)
    eng.flush_updates()
    # the flush committed a marker but did NOT truncate: the artifact on disk
    # still predates the flush, the journal is the only durable copy
    assert os.path.getsize(wal) > base
    eng.save(str(tmp_path / "fresh.npz"))
    assert os.path.getsize(wal) == base


def test_attach_journal_refuses_a_second_journal_and_staged_ops(built, tmp_path):
    g, bn, objects, _, art = built
    eng = _load(art, bn, journal=str(tmp_path / "a.bin"))
    with pytest.raises(knn.ArtifactError, match="already has a journal"):
        eng.attach_journal(str(tmp_path / "b.bin"))
    other = _load(art, bn)
    other.stage_insert(next(v for v in range(g.n) if v not in set(other.objects.tolist())))
    with pytest.raises(knn.ArtifactError, match="predate the journal"):
        other.attach_journal(str(tmp_path / "c.bin"))


def test_error_taxonomy_types():
    for err, builtin in [
        (knn.QueryError, ValueError),
        (knn.StagedUpdateError, ValueError),
        (knn.EngineConfigError, ValueError),
        (knn.EpochError, ValueError),
        (knn.ArtifactError, RuntimeError),
        (knn.JournalError, RuntimeError),
    ]:
        assert issubclass(err, knn.RepError)
        assert issubclass(err, builtin)
    assert issubclass(knn.JournalError, knn.ArtifactError)


# ---------------------------------------------------------------------------
# kill points
# ---------------------------------------------------------------------------


def _crash(eng, mset, phase):
    """Stage the batch the crash interrupts and die at ``phase``; returns the
    extra insert a post-journal-append kill leaves durable (or None)."""
    _stage_mix(eng, mset, seed=2)
    fired = []

    def hook(e, ph):
        if ph == phase:
            fired.append(ph)
            raise SimulatedKill(ph)

    eng.checkpoint_hook = hook
    extra = None
    if phase == "post-journal-append":
        # the kill lands between the fsync and the ack: the record is durable,
        # so recovery MUST apply it
        extra = next(w for w in range(eng.n) if w not in mset)
        with pytest.raises(SimulatedKill):
            eng.stage_insert(extra)
        mset.add(extra)
    else:
        with pytest.raises(SimulatedKill):
            eng.flush_updates()
    assert fired, f"phase {phase} never fired"
    eng.checkpoint_hook = None
    return extra


def _uncrashed(twin, objects, extra):
    tset = set(int(o) for o in objects)
    _stage_mix(twin, tset, seed=1)
    twin.flush_updates()
    _stage_mix(twin, tset, seed=2)
    if extra is not None:
        twin.stage_insert(extra)
        tset.add(extra)
    twin.flush_updates()
    return tset


@pytest.mark.parametrize("phase", PHASES)
def test_kill_point_recovery(phase, tmp_path):
    g, bn, objects, k = _setup()
    art, wal = str(tmp_path / "idx.npz"), str(tmp_path / "wal.bin")
    eng = knn.build_engine(bn, objects, k, device="cpu")
    mset = set(int(o) for o in objects)
    eng.save(art)
    eng.attach_journal(wal)
    _stage_mix(eng, mset, seed=1)  # committed segment: flushed before the kill
    eng.flush_updates()
    extra = _crash(eng, mset, phase)

    rec = _load(art, bn, journal=wal)  # reboot: the artifact + the journal
    twin = _load(art, bn)
    assert _uncrashed(twin, objects, extra) == mset
    _assert_same(rec, twin)
    us = np.arange(g.n, dtype=np.int32)
    for a, b in zip(rec.query_batch(us), twin.query_batch(us)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    fresh = knn.knn_index_cons_plus(bn, np.array(sorted(mset)), k)
    assert knn.indices_equivalent(fresh, rec.to_index())


def test_failed_flush_rolls_back_and_is_retryable():
    g, bn, objects, k = _setup()
    eng = knn.build_engine(bn, objects, k, device="cpu")
    mset = set(int(o) for o in objects)
    us = np.arange(g.n, dtype=np.int32)
    before = [t.clone() for t in eng.query_batch(us)]
    epoch0 = eng.epoch
    _stage_mix(eng, mset, seed=3)
    depth = eng.queue_depth

    def hook(e, ph):
        if ph == "pre-swap":
            raise SimulatedKill(ph)

    eng.checkpoint_hook = hook
    with pytest.raises(SimulatedKill):
        eng.flush_updates()
    eng.checkpoint_hook = None
    assert eng.epoch == epoch0 and eng.queue_depth == depth
    assert eng.stats()["flushes_failed"] == 1
    for a, b in zip(eng.query_batch(us), before):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert eng.flush_updates()["staged"] == depth
    assert eng.epoch == epoch0 + 1
    fresh = knn.knn_index_cons_plus(bn, np.array(sorted(mset)), k)
    assert knn.indices_equivalent(fresh, eng.to_index())


@pytest.mark.parametrize("partial", [0, 1, 7])
def test_kill_at_journal_creation_recovers_fresh(partial, tmp_path):
    """A kill between the journal file's creation and its magic fsync leaves
    0-7 bytes of partial magic and no record: reboot adopts it as a fresh
    journal. A full-length wrong magic is someone else's file and raises."""
    g, bn, objects, k = _setup()
    art, wal = str(tmp_path / "idx.npz"), str(tmp_path / "wal.bin")
    knn.build_engine(bn, objects, k, device="cpu").save(art)
    with open(wal, "wb") as f:
        f.write(b"RKNNWAL1"[:partial])
    rec = _load(art, bn, journal=wal)
    mset = set(int(o) for o in objects)
    _stage_mix(rec, mset, seed=4)
    rec.flush_updates()
    _assert_same(_load(art, bn, journal=wal), rec)
    bad = str(tmp_path / "notmine.bin")
    with open(bad, "wb") as f:
        f.write(b"SQLITEv3")
    with pytest.raises(knn.JournalError):
        knn.UpdateJournal(bad)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


def _jax_setup():
    g = jknn.road_network(8, 8, seed=0)
    objects = jknn.pick_objects(g.n, 0.2, seed=0)
    return jknn.build_bngraph(g), objects


def test_artifacts_load_across_packages(tmp_path):
    _, bn, objects, k = _setup()
    jbn, jobjects = _jax_setup()
    np.testing.assert_array_equal(objects, jobjects)
    teng = knn.build_engine(bn, objects, k, device="cpu")
    jeng = jknn.build_engine(jbn, jobjects, k)
    t_art, j_art = str(tmp_path / "torch.npz"), str(tmp_path / "jax.npz")
    teng.save(t_art)
    jeng.save(j_art)
    # the two files hold the same arrays, types and meta (checksum included)
    with np.load(t_art) as zt, np.load(j_art) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for f in zt.files:
            assert zt[f].dtype == zj[f].dtype, f
            np.testing.assert_array_equal(zt[f], zj[f])
    assert json.loads(bytes(np.load(t_art)["meta"])) == json.loads(bytes(np.load(j_art)["meta"]))
    # a JAX-written artifact loads in the port, a port-written one in JAX
    _assert_same(_load(j_art, bn), jeng)
    _assert_same(jknn.load_engine(t_art, bn=jbn), teng)


@pytest.mark.parametrize("phase", ["mid-repair-round", "post-journal-append"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_recovers_across_packages(writer, phase, tmp_path):
    """One package's engine is killed mid-flush (or right after a journal
    append); its artifact and journal recover in BOTH packages, to the same
    epoch, object set and tables."""
    _, bn, objects, k = _setup()
    jbn, _ = _jax_setup()
    art, wal = str(tmp_path / "idx.npz"), str(tmp_path / "wal.bin")
    eng = (jknn.build_engine(jbn, objects, k) if writer == "jax"
           else knn.build_engine(bn, objects, k, device="cpu"))
    eng.save(art)
    journal = eng.attach_journal(wal)
    mset = set(int(o) for o in objects)
    _stage_mix(eng, mset, seed=1)
    eng.flush_updates()
    _crash(eng, mset, phase)
    journal.close()
    # recovery appends a commit marker: each package replays its own copy
    shutil.copy(wal, wal + ".jax")
    shutil.copy(wal, wal + ".torch")
    jrec = jknn.load_engine(art, bn=jbn, journal=wal + ".jax")
    trec = _load(art, bn, journal=wal + ".torch")
    _assert_same(trec, jrec)
    assert set(trec.objects.tolist()) == mset
    with open(wal + ".jax", "rb") as a, open(wal + ".torch", "rb") as b:
        assert a.read() == b.read()  # the same records, the same tail commit
