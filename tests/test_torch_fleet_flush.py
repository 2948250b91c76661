"""The scalar engine's flush as a moving fleet drives it, on the CPU.

* The frontier's candidate lists are compacted on the device
  (``QueryEngine._compact_on_device``) in exactly the layout of the host
  compaction ``sharded.compact_candidates``: empty rows dropped, an
  all-true row, ties, widths padded past the source count.
* A flush in which every object moves one street at once leaves tables and
  stats equal to the JAX engine's after every flush, and no (rows x sources)
  array crosses to the host in it; with extra inserts or deletes too, it
  calls none of the sharded engine's host set algebra.
* The receiver sets the scalar engine builds on the device each round are
  the host sets of ``repro_torch.core.sharded`` (the JAX engine's), split
  into the same parts, at the same widths, in the same order:
  for sets built from chosen changed rows, and round by round through whole
  flushes, on a graph with a row in every width bucket and a degree-0 row.
* The flush's five spans nest in order under a profiler, and its counters
  hold what the flush did: ``d2h_bytes`` the bytes ``_readback`` returned,
  the round counts of the stats dict, ``k3_bytes`` K3's least bytes
  recounted on the host from the BN-Graph, and ``receiver_rows`` the sizes
  of the host receiver sets.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core.bngraph import build_bngraph as jax_build_bngraph
from repro.core.engine import QueryEngine as JaxEngine
from repro.core.reference import knn_index_cons_plus as jax_cons_plus
from repro.graph.csr import from_edges as jax_from_edges
from repro.graph.generators import pick_objects
from repro.graph.generators import road_network as jax_road_network
from repro_torch import trace
from repro_torch.core import engine, sharded
from repro_torch.core.bngraph import bngraph_from_arrays
from repro_torch.core.engine import QueryEngine
from repro_torch.core.sharded import (
    ShardedQueryEngine,
    bucket_parts,
    compact_candidates,
    expand_receivers,
    repair_receivers,
)
from repro_torch.graph.csr import from_edges
from repro_torch.graph.generators import road_network

FLUSH = "repro_torch.flush_updates"
PHASES = ("repro_torch.flush.delete_scan", "repro_torch.flush.frontier",
          "repro_torch.flush.purge_merge", "repro_torch.flush.repair")
STATS = ("flushes", "inserts_applied", "deletes_applied", "moves_applied", "coalesced",
         "rows_repaired", "repair_rounds_last", "frontier_rounds_last")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread keeps them fast under a
    parallel test run (see tests/test_torch_sharded.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fleet(grid: int, mu: float, k: int, seed: int = 0, hub: int = 0):
    """(road network, JAX engine, port engine) over identical BN-Graph and
    tables, objects at density ``mu``. ``hub`` > 0 adds two vertices: a hub
    joined to ``hub`` random vertices (a row in the widest width bucket) and
    an isolated vertex (a degree-0 row), ids n and n+1 of the grid."""
    jg = jax_road_network(grid, grid, seed=seed)
    g = road_network(grid, grid, seed=seed)
    if hub:
        edges = [(u, int(v), float(w)) for u in range(g.n)
                 for v, w in zip(*g.neighbors(u)) if u < v]
        rng = np.random.default_rng(seed)
        edges += [(g.n, int(v), float(rng.integers(1, 10)))
                  for v in rng.choice(g.n, hub, replace=False)]
        jg, g = jax_from_edges(g.n + 2, edges), from_edges(g.n + 2, edges)
    objects = pick_objects(jg.n, mu, seed=seed)
    jbn = jax_build_bngraph(jg)
    bn = bngraph_from_arrays(**{f.name: getattr(jbn, f.name) for f in dataclasses.fields(jbn)})
    je = JaxEngine.from_index(jax_cons_plus(jbn, objects, k), objects, bn=jbn)
    ids, d = (np.asarray(t) for t in je.tables)
    te = QueryEngine.from_tables(ids, d, k, objects, bn=bn, device="cpu")
    return g, je, te


def _move_every_object(g, engines, objects: set, rng) -> int:
    """Each object, in a random order, moves to a free neighbouring vertex
    (one street), staged on every engine; returns the moves staged."""
    moved = 0
    for u in rng.permutation(sorted(objects)).tolist():
        free = [v for v in g.neighbors(u)[0].tolist() if v not in objects]
        if not free:
            continue
        v = int(rng.choice(free))
        for eng in engines:
            eng.stage_move(u, v)
        objects.discard(u)
        objects.add(v)
        moved += 1
    return moved


def _tables_equal(je, te):
    ji, jd = (np.asarray(t) for t in je.tables)
    ti, td = (t.numpy() for t in te.tables)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


# ---------------------------------------------------------------------------
# the device compaction
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_engine():
    return _fleet(8, 0.1, 4)[2]


def _mask_case(r: int, b: int, density: float, seed: int):
    rng = np.random.default_rng(seed)
    aff = rng.random((r, b)) < density
    aff[0] = False                       # an empty row
    aff[min(1, r - 1)] = True            # an all-true row
    # few distinct distances: ties within a row and across rows
    dvals = rng.integers(0, 4, size=(r, b)).astype(np.float32)
    dvals[rng.random((r, b)) < 0.1] = np.inf
    rows = np.sort(rng.choice(10 * r, size=r, replace=False)).astype(np.int32)
    src = np.sort(rng.choice(10 * r, size=b, replace=False)).astype(np.int32)
    return rows, aff, dvals, src


@pytest.mark.parametrize("r,b,density,seed", [
    (6, 3, 0.5, 0),      # an all-true row of 3: width 4, past the 3 sources
    (5, 1, 0.5, 1),      # one source column
    (40, 37, 0.1, 2),    # an all-true row of 37: width 64
    (64, 9, 0.9, 3),
    (33, 130, 0.02, 4),
    (1, 5, 0.0, 5),      # every row empty
])
def test_device_compaction_equals_the_host_compaction(small_engine, r, b, density, seed):
    rows, aff, dvals, src = _mask_case(r, b, density, seed)
    want = compact_candidates(rows, aff, dvals, src)
    got = small_engine._compact_on_device(rows, torch.from_numpy(aff), torch.from_numpy(dvals),
                                          torch.from_numpy(src))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.int32
    for g, w in zip(got[1:], want[1:]):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# a fleet's flushes against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid,mu,k", [(12, 0.08, 4), (16, 0.12, 20)])
def test_every_object_moving_at_once_matches_jax_after_every_flush(grid, mu, k, monkeypatch):
    g, je, te = _fleet(grid, mu, k, seed=grid)
    crossed = []
    real = QueryEngine._readback

    def readback(self, x):
        crossed.append(tuple(x.shape))
        return real(self, x)
    monkeypatch.setattr(QueryEngine, "_readback", readback)
    objects = set(te.objects.tolist())
    rng = np.random.default_rng(k)
    for _ in range(3):
        staged = _move_every_object(g, (je, te), objects, rng)
        assert staged >= 0.9 * len(objects)
        res = te.flush_updates()
        # a vehicle may enter a vertex another left this tick: the chain
        # coalesces, so the net moves can be fewer than the staged ones
        assert res == je.flush_updates() and res["staged"] == staged
        _tables_equal(je, te)
        ts, js = te.stats(), je.stats()
        assert {key: ts[key] for key in STATS} == {key: js[key] for key in STATS}
    np.testing.assert_array_equal(te.objects, je.objects)
    # masks and counts only: nothing of (rows x sources) came back
    assert crossed and all(len(shape) == 1 for shape in crossed)


def test_a_hub_and_an_isolated_vertex_match_jax_after_every_flush():
    # a row in each of the four width buckets (the hub's above 128), and a
    # degree-0 row that an object enters and leaves: purged, in no part
    g, je, te = _fleet(14, 0.1, 4, seed=14, hub=170)
    hub, iso = g.n - 2, g.n - 1
    te._nbr_tables()
    assert len(te._bucket_widths()) == 4 and te._nbr_deg[hub] > 128 and te._nbr_deg[iso] == 0
    objects = set(te.objects.tolist())
    rng = np.random.default_rng(14)
    for step in range(3):
        _move_every_object(g, (je, te), objects, rng)
        for eng in (je, te):
            if step == 0 and iso not in objects:
                eng.stage_insert(iso)
            if step == 1:
                eng.stage_delete(iso)
            if step == 2 and hub not in objects:
                eng.stage_insert(hub)
        objects = set(te._pending)
        assert te.flush_updates() == je.flush_updates()
        _tables_equal(je, te)


@pytest.mark.parametrize("heavy", ["inserts", "deletes"])
def test_the_scalar_flush_never_calls_the_host_set_algebra(monkeypatch, heavy):
    # the host round loop is the sharded engine's: with its four set-algebra
    # functions raising, flushes that move every object, with as many extra
    # inserts or deletes as a third of the fleet, still match the JAX engine
    def boom(*args, **kwargs):
        raise AssertionError("the host set algebra was called")
    for name in ("bucket_parts", "expand_receivers", "repair_receivers", "compact_candidates"):
        monkeypatch.setattr(sharded, name, boom)
        assert not hasattr(engine, name)
    g, je, te = _fleet(12, 0.15, 4, seed=12)
    objects = set(te.objects.tolist())
    rng = np.random.default_rng(12)
    for _ in range(3):
        _move_every_object(g, (je, te), objects, rng)
        pool = sorted(set(range(g.n)) - objects) if heavy == "inserts" else sorted(objects)
        extra = rng.choice(pool, len(objects) // 3, replace=False).tolist()
        for eng in (je, te):
            for v in extra:
                (eng.stage_insert if heavy == "inserts" else eng.stage_delete)(v)
        objects = set(te._pending)
        assert te.flush_updates() == je.flush_updates()
        _tables_equal(je, te)
        ts, js = te.stats(), je.stats()
        assert {key: ts[key] for key in STATS} == {key: js[key] for key in STATS}
    # the same flush on the sharded engine reaches the patched functions
    ids, d = (t.numpy() for t in te.tables)
    se = ShardedQueryEngine(ids, d, te.k, te.objects, bn=te.bn, device="cpu")
    _move_every_object(g, (se,), objects, rng)
    with pytest.raises(AssertionError, match="host set algebra"):
        se.flush_updates()


# ---------------------------------------------------------------------------
# receiver sets built on the device
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hub_engine():
    g, _, te = _fleet(14, 0.1, 4, seed=14, hub=170)
    te._receiver_tables()
    return te, g.n - 2, g.n - 1


def _vertex_mask(te, rows: np.ndarray) -> torch.Tensor:
    mask = te._vertex_mask()
    te._mark(mask, torch.from_numpy(np.asarray(rows, np.int32)))
    return mask


def _host_parts(te, rows):
    """The host split of ``rows``: ``bucket_parts``' (width, rows) pairs."""
    return bucket_parts(te._nbr_deg, te._bucket_widths(), rows)


def _expand(te, active):
    return expand_receivers(te._nbr_indptr, te._nbr_indices, active)


def _assert_parts(te, got, want):
    """Device parts ``got`` are the host parts ``want`` ((width, rows)
    pairs), in order, each at its bucket's width; the dummy row n is in
    none."""
    assert len(got) == len(want)
    widths = te._bucket_widths()
    for (t, part), (wt, w) in zip(got, want):
        assert t == wt and part.dtype == torch.int32
        np.testing.assert_array_equal(part.numpy(), w)
        deg = te._nbr_deg[w]
        lo = ([0] + widths)[widths.index(t)]
        assert ((deg > lo) & (deg <= t)).all()
        assert te.n not in part.numpy()


@pytest.mark.parametrize("kind", ["repair", "frontier"])
@pytest.mark.parametrize("case", ["empty", "one", "degree-0", "widest", "every", "random"])
def test_receiver_parts_built_on_the_device_equal_the_host_parts(hub_engine, kind, case):
    te, hub, iso = hub_engine
    n = te.n
    rng = np.random.default_rng(sum(map(ord, kind + case)))
    changed = {
        "empty": np.empty(0, np.int32),
        "one": rng.choice(n, 1),
        "degree-0": np.array([iso]),
        "widest": np.array([hub]),
        "every": np.arange(n),
        "random": rng.choice(n, n // 4, replace=False),
    }[case].astype(np.int32)
    # the rows that ran this round: the changed ones among others
    ran = np.union1d(changed, rng.choice(n, n // 3, replace=False)).astype(np.int32)
    ran_parts = te._receiver_parts(_vertex_mask(te, ran))
    _assert_parts(te, ran_parts, _host_parts(te, ran))
    ran = [(t, part, torch.from_numpy(np.isin(part.numpy(), changed))) for t, part in ran_parts]
    if kind == "repair":
        rows = np.arange(n) if case == "every" else rng.choice(n, 3 * n // 5, replace=False)
        rows = np.sort(rows).astype(np.int32)
        got = te._next_receivers(ran, narrow=_vertex_mask(te, rows))
        want = repair_receivers(te.bn.lo_ids, te.bn.hi_ids, changed, rows)
    else:
        touched = te._vertex_mask()
        got = te._next_receivers(ran, touched=touched)
        want = _expand(te, changed)
        # the changed rows that ran: a degree-0 row is in no part
        np.testing.assert_array_equal(np.flatnonzero(touched[:n].numpy()),
                                      np.unique(changed[te._nbr_deg[changed] > 0]))
    _assert_parts(te, got, _host_parts(te, want))
    if case in ("empty", "degree-0"):
        assert got == []


def _replay(te, parts, first, expand):
    """Walk the host round loop over recorded device parts: each round's
    parts must be ``bucket_parts`` of the host receiver set (``first``,
    then ``expand(changed rows)``); returns the rounds and the summed sizes
    of the sets ``expand`` built."""
    active, rounds, built = first, 0, 0
    while active.size:
        want = _host_parts(te, active)
        got, parts = parts[:len(want)], parts[len(want):]
        assert len(got) == len(want)
        for (part, _), (_, w) in zip(got, want):
            np.testing.assert_array_equal(part, w)
        rounds += 1
        changed = np.concatenate([p[m] for p, m in got] + [np.empty(0, np.int32)])
        active = expand(changed) if changed.size else changed
        built += active.size
    assert parts == []
    return rounds, built


def test_receiver_rows_counts_the_host_receiver_sets(monkeypatch):
    g, je, te = _fleet(12, 0.08, 4, seed=7)
    objects = set(te.objects.tolist())
    _move_every_object(g, (te,), objects, np.random.default_rng(7))
    seen = {"repair": [], "frontier": []}
    real = {name: getattr(QueryEngine, name) for name in
            ("_repair", "_insert_frontier", "_repair_part", "_frontier_part")}

    def repair(self, rows):
        seen["purged"] = np.array(rows)
        return real["_repair"](self, rows)

    def insert_frontier(self, inserts):
        seen["src"] = np.asarray(inserts, np.int32)
        return real["_insert_frontier"](self, inserts)

    def repair_part(self, part, t):
        changed = real["_repair_part"](self, part, t)
        seen["repair"].append((part.numpy().copy(), changed.numpy().copy()))
        return changed

    def frontier_part(self, state, part):
        state, changed = real["_frontier_part"](self, state, part)
        seen["frontier"].append((part.numpy().copy(), changed.numpy().copy()))
        return state, changed
    for name, fn in (("_repair", repair), ("_insert_frontier", insert_frontier),
                     ("_repair_part", repair_part), ("_frontier_part", frontier_part)):
        monkeypatch.setattr(QueryEngine, name, fn)
    res = te.flush_updates()
    purged = seen["purged"]
    r_rounds, r_built = _replay(te, seen["repair"], purged,
                                lambda c: repair_receivers(te.bn.lo_ids, te.bn.hi_ids, c, purged))
    first = _expand(te, np.unique(seen["src"]))
    f_rounds, f_built = _replay(te, seen["frontier"], first,
                                lambda c: _expand(te, c))
    assert (r_rounds, f_rounds) == (res["repair_rounds"], res["frontier_rounds"])
    assert r_rounds > 1 and f_rounds > 1
    assert trace.last(FLUSH)["receiver_rows"] == r_built + first.size + f_built > 0


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith(("repro_torch.flush", FLUSH))]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def _k3_rule(te, parts, b: int) -> int:
    """K3's least bytes recounted from the packed BNS adjacency."""
    total = 0
    for part in parts:
        deg = te._nbr_deg[part]
        nbrs = np.concatenate([te._nbr_ids[v, :d] for v, d in zip(part, deg)])
        total += 8 * int(deg.sum()) + 4 * b * (len(np.unique(nbrs)) + len(part))
    return total


def test_flush_spans_nest_in_order_and_counters_hold_what_it_did(monkeypatch, tmp_path):
    g, je, te = _fleet(12, 0.08, 4, seed=5)
    objects = set(te.objects.tolist())
    _move_every_object(g, (te,), objects, np.random.default_rng(5))
    returned, parts = [], []
    real_readback, real_part = QueryEngine._readback, QueryEngine._frontier_part

    def readback(self, x):
        out = real_readback(self, x)
        returned.append(out.nbytes)
        return out

    def part(self, state, rows):
        parts.append(np.array(rows))
        return real_part(self, state, rows)
    monkeypatch.setattr(QueryEngine, "_readback", readback)
    monkeypatch.setattr(QueryEngine, "_frontier_part", part)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = te.flush_updates()
    spans = _annotations(prof, tmp_path)
    assert [s[0] for s in spans] == [FLUSH, *PHASES]
    outer = spans[0]
    assert all(outer[1] <= s[1] and s[2] <= outer[2] for s in spans[1:])
    assert all(a[2] <= b[1] for a, b in zip(spans[1:], spans[2:]))
    counts = trace.last(FLUSH)
    assert counts["d2h_bytes"] == sum(returned) > 0
    assert counts["frontier_rounds"] == res["frontier_rounds"] > 0
    assert counts["repair_rounds"] == res["repair_rounds"] > 0
    assert res["rows_merged"] <= counts["rows_touched"] <= te.n
    b = res["inserts"] + res["moves"]  # the frontier's source columns
    assert counts["k3_bytes"] == _k3_rule(te, parts, b)


def test_a_flush_outside_a_profiler_still_counts():
    g, je, te = _fleet(8, 0.1, 4, seed=2)
    objects = set(te.objects.tolist())
    _move_every_object(g, (te,), objects, np.random.default_rng(2))
    res = te.flush_updates()
    counts = trace.last(FLUSH)
    assert counts["frontier_rounds"] == res["frontier_rounds"]
    assert set(counts) == {"d2h_bytes", "h2d_bytes", "frontier_rounds", "repair_rounds",
                           "rows_touched", "k3_bytes", "receiver_rows"}
