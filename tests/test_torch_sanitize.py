"""The port's runtime rail (``repro_torch.analysis.sanitize``) held to the JAX
package's (``repro.analysis.sanitize``), case for case with
``tests/analysis/test_sanitize.py``.

What a CPU run can and cannot show: torch's sync debug mode acts on CUDA work
only, so on CPU tensors nothing syncs and the guard never raises here. These
tests check the guard's plumbing (a no-op when disabled, the mode it found
restored on every exit, torch's error translated to ``SanitizerError``) with
the mode getter/setter stood in for, and leave the proof that the guard fires
to ``chip_smoke.py``'s ``sanitize`` phase. Everything else is device-
independent and exact: the transfer and build counts, the table scan (its
messages equal to the JAX rail's on the same arrays), the poisoned cases
(the port's plain versions equal to the JAX reference functions), and the
engines in sanitizer mode (tables equal to the JAX engine's after every
flush).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import knn as jknn
from repro.analysis import sanitize as jsanitize
from repro.core.errors import SanitizerError as JaxSanitizerError
from repro.core.reference import knn_index_cons_plus
from repro.graph.generators import pick_objects, road_network
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.analysis import sanitize
from repro_torch.core.bngraph import bngraph_from_arrays
from repro_torch.core.engine import QueryEngine
from repro_torch.core.errors import SanitizerError
from repro_torch.core.sharded import ShardedQueryEngine
from repro_torch.kernels import _build, ops

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread keeps them fast under a
    parallel test run (see tests/test_torch_sharded.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# sync guard
# ---------------------------------------------------------------------------


class _FakeMode:
    """Stands in for torch's process-wide sync debug mode (the CPU build has
    no CUDA to ask); records every mode set."""

    def __init__(self, monkeypatch):
        self.mode = 0
        self.sets: list[int] = []
        monkeypatch.setattr(sanitize, "_get_mode", lambda: self.mode)
        monkeypatch.setattr(sanitize, "_set_mode", self._set)

    def _set(self, mode):
        self.sets.append(mode)
        self.mode = mode


def test_guard_is_noop_when_disabled(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    fake = _FakeMode(monkeypatch)
    with sanitize.guard("test"):
        torch.arange(4).sum().item()  # a sync on the card, but the guard is off
    assert fake.sets == []


def test_guard_sets_error_mode_and_restores_it_after_exceptions(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    fake = _FakeMode(monkeypatch)
    for _ in range(5):
        with pytest.raises(ValueError):
            with sanitize.guard("flush"):
                assert fake.mode == 2
                with sanitize.explicit("d2h"):  # a helper lifts the mode ...
                    assert fake.mode == 0
                assert fake.mode == 2  # ... and puts back what it found
                with sanitize.no_transfers("inner"):  # nested guards too
                    assert fake.mode == 2
                raise ValueError("an exception inside the guarded block")
        assert fake.mode == 0
    assert fake.sets == [2, 0, 2, 0] * 5


def test_torch_sync_error_becomes_sanitizer_error(monkeypatch):
    # torch's own message under sync debug mode "error"; on the card the
    # sanitize phase of chip_smoke.py plants a real one
    _FakeMode(monkeypatch)
    with pytest.raises(SanitizerError, match="implicit host sync on the `query` path"):
        with sanitize.no_transfers("query"):
            raise RuntimeError("called a synchronizing CUDA operation")
    with pytest.raises(RuntimeError, match="unrelated"):
        with sanitize.no_transfers("query"):
            raise RuntimeError("unrelated")
    assert sanitize.is_sync_error(RuntimeError("called a synchronizing CUDA operation"))
    assert not sanitize.is_sync_error(SanitizerError("called a synchronizing CUDA operation"))


def test_guard_runs_the_engine_paths_on_cpu(small, monkeypatch):
    # a CPU run under the guard: nothing to raise, the paths still work
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    je, te, g, objects = small["jax"], small["port"](), small["g"], small["objects"]
    us = np.arange(g.n, dtype=np.int32)
    with sanitize.no_transfers("query"):
        ids, d = te.query_batch(us)
    j_ids, j_d = je.query_batch(us)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(d.numpy(), np.asarray(j_d))


# ---------------------------------------------------------------------------
# transfer counting
# ---------------------------------------------------------------------------


def test_count_transfers_counts_the_two_helpers(small):
    te = small["port"]()
    with sanitize.count_transfers() as t:
        x = te._upload(np.arange(8, dtype=np.int32))
        te._readback(x)
        with sanitize.count_transfers() as inner:  # counters nest
            te._upload(np.arange(3))
    assert (t.h2d, t.d2h, t.total) == (2, 1, 3)
    assert (inner.h2d, inner.d2h) == (1, 0)


@pytest.mark.parametrize("layout,h2d", [("scalar", 2), ("shards=2", 3)])
def test_query_batch_transfers(small, layout, h2d):
    # the query ids and the per-query k go up (the sharded engine also sends
    # its shard boundaries); the (B, k) answers stay on the device
    te = small["port"](layout)
    with sanitize.count_transfers() as t:
        te.query_batch(np.arange(32, dtype=np.int32))
    assert (t.h2d, t.d2h) == (h2d, 0)


# exact (h2d, d2h) of the small engine's flush of 4 inserts + 2 deletes;
# sanitizer mode adds the post-flush scan's readbacks (and the sharded
# engine's upload of its vertex -> row map). A new host round trip on the
# flush path changes these numbers. The scalar engine compacts the frontier's
# candidates on the device: one readback of per-row counts where the host
# compaction read the mask and the distances, and the kept rows' positions go
# up where the candidate lists did. It also builds each round's receiver parts
# on the device: no part goes up and no changed mask comes back, one readback
# of the bucket sizes a round (and one for the round-1 split) does. Its 4
# inserts + 2 deletes (5 frontier rounds, 3 repair rounds, bucket widths 8 and
# 18) cross as
#   h2d 13 = deleted ids 1 + bucket vector 1 + sources 1 + two bucket slices
#            of 2 tables (18 for the sources' neighbours, 8) 4 + touched rows
#            and kept positions 2 + placed positions 1 + purge rows and
#            deleted ids 2 + purged rows 1
#   d2h 13 = delete-scan mask 1 + frontier sizes 1 + 5 + touched mask 1 +
#            per-row counts 1 + repair sizes 1 + 3
_FLUSH_COUNTS = {
    ("scalar", False): (13, 13), ("scalar", True): (13, 15),
    ("shards=2", False): (82, 26), ("shards=2", True): (83, 28),
    ("shards=2,host", False): (102, 40), ("shards=2,host", True): (103, 42),
}


@pytest.mark.parametrize("sanitizer", [False, True], ids=["plain", "sanitize"])
@pytest.mark.parametrize("layout", ["scalar", "shards=2", "shards=2,host"])
def test_flush_transfers_are_pinned(small, monkeypatch, layout, sanitizer):
    if sanitizer:
        monkeypatch.setenv("REPRO_SANITIZE", "1")
    else:
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    te = small["port"](layout)
    for v in small["ins"]:
        te.stage_insert(v)
    for v in small["dels"]:
        te.stage_delete(v)
    with sanitize.count_transfers() as t:
        te.flush_updates()
    assert (t.h2d, t.d2h) == _FLUSH_COUNTS[(layout, sanitizer)]


# ---------------------------------------------------------------------------
# build counting + budgets
# ---------------------------------------------------------------------------


def test_count_builds_reads_the_build_log(monkeypatch):
    monkeypatch.setattr(_build, "BUILT", ["libearlier.so"])
    with sanitize.count_builds() as c:
        assert c.count == 0
        _build.BUILT.append("libtopk_merge-0.so")
        assert c.count == 1  # live inside the block
    _build.BUILT.append("liblater.so")
    assert (c.count, c.libraries) == (1, ["libtopk_merge-0.so"])


def test_assert_builds_within(tmp_path, monkeypatch):
    budgets = tmp_path / "budgets.json"
    budgets.write_text('{"api": {"cold_max": 3, "warm": 0}}')
    monkeypatch.setenv("REPRO_BUILD_BUDGETS", str(budgets))
    sanitize.assert_builds_within("api", cold=3, warm=0)
    with pytest.raises(SanitizerError, match="cold"):
        sanitize.assert_builds_within("api", cold=4)
    with pytest.raises(SanitizerError, match="warm"):
        sanitize.assert_builds_within("api", warm=1)
    with pytest.raises(SanitizerError, match="no build budget"):
        sanitize.assert_builds_within("missing")


def test_checked_in_budgets_cover_the_serving_paths():
    budgets = json.loads((REPO / "tools" / "torch_build_budgets.json").read_text())
    assert set(budgets) == {"query_batch", "flush_updates", "sharded_query_batch",
                            "sharded_flush_updates"}
    # the query path launches no kernel; a flush may build every library once
    assert budgets["query_batch"]["cold_max"] == budgets["sharded_query_batch"]["cold_max"] == 0
    assert budgets["flush_updates"]["cold_max"] == len(_build.KERNELS)
    assert all(b["warm"] == 0 for b in budgets.values())


@pytest.mark.parametrize("layout,api", [("scalar", ""), ("shards=2", "sharded_")])
def test_serving_paths_build_within_budget(small, layout, api):
    # on CPU tensors the wrappers run their plain versions: nothing builds,
    # cold or warm, and the checked-in budgets hold that
    te = small["port"](layout)
    us = np.arange(32, dtype=np.int32)
    with sanitize.count_builds() as cold:
        te.query_batch(us)
    with sanitize.count_builds() as warm:
        te.query_batch(us)
    sanitize.assert_builds_within(f"{api}query_batch", cold=cold.count, warm=warm.count)
    for v in small["ins"]:
        te.stage_insert(v)
    with sanitize.count_builds() as cold:
        te.flush_updates()
    for v in small["ins"]:
        te.stage_delete(v)
    with sanitize.count_builds() as warm:
        te.flush_updates()
    sanitize.assert_builds_within(f"{api}flush_updates", cold=cold.count, warm=warm.count)


def test_enable_compile_cache_noop_without_path(monkeypatch):
    monkeypatch.delenv("REPRO_COMPILE_CACHE", raising=False)
    assert sanitize.enable_compile_cache(None) is None
    assert _build.build_dir() == REPO / "build"


def test_build_dir_follows_the_variable_and_the_flag(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_COMPILE_CACHE", str(tmp_path / "env"))
    assert _build.build_dir() == tmp_path / "env"
    assert _build._lib_path("topk_merge").parent == tmp_path / "env"
    assert sanitize.enable_compile_cache(None) == tmp_path / "env"  # the variable alone
    got = sanitize.enable_compile_cache(tmp_path / "flag")
    assert got == tmp_path / "flag" and got.is_dir()
    assert _build.build_dir() == tmp_path / "flag"  # the flag beats the variable


def test_serve_compile_cache_flag_names_the_build_dir(tmp_path):
    code = (
        "import sys\n"
        "from repro_torch.kernels import _build\n"
        "from repro_torch.launch import serve\n"
        f"sys.argv = ['serve', '--compile-cache', {str(tmp_path / 'kc')!r}, '--arch', 'x']\n"
        "try:\n"
        "    serve.main()\n"
        "except SystemExit:\n"
        "    pass\n"
        "print(_build.build_dir())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("REPRO_COMPILE_CACHE", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path / "kc")
    assert (tmp_path / "kc").is_dir()


# ---------------------------------------------------------------------------
# table scan
# ---------------------------------------------------------------------------


def _good_tables(n=6, k=3):
    ids = np.array([[1, 2, -1]] * n, np.int32)
    d = np.array([[0.5, 1.0, np.inf]] * n, np.float32)
    return ids, d


def test_scan_tables_accepts_valid():
    ids, d = _good_tables()
    sanitize.scan_tables(ids, d, 6)


_CORRUPTIONS = [
    (lambda ids, d: d.__setitem__((0, 0), np.nan), "NaN"),
    (lambda ids, d: d.__setitem__((0, 0), -1.0), "negative"),
    (lambda ids, d: ids.__setitem__((0, 0), 99), "outside"),
    (lambda ids, d: d.__setitem__((0, 2), 2.0), "pad slots"),
    (lambda ids, d: (ids.__setitem__((0, 0), -1), d.__setitem__((0, 0), np.inf)),
     "right of pad"),
    (lambda ids, d: d.__setitem__((0, 0), 1.5), "sorted"),
]


@pytest.mark.parametrize("mutate,msg", _CORRUPTIONS, ids=[m for _, m in _CORRUPTIONS])
def test_scan_tables_rejects_corruption(mutate, msg):
    ids, d = _good_tables()
    mutate(ids, d)
    with pytest.raises(SanitizerError, match=msg) as got:
        sanitize.scan_tables(ids, d, 6, context="flush -> epoch 3")
    with pytest.raises(JaxSanitizerError) as want:
        jsanitize.scan_tables(ids, d, 6, context="flush -> epoch 3")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# poisoned cases: the port's plain versions against the JAX references
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cases():
    return sanitize.poisoned_cases()


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.array(x))


def test_poisoned_sweep_merge_equals_jax_ref(cases):
    c = cases["sweep_merge"]
    keys = ("nbr", "verts", "w", "ex_ids", "ex_d", "vk_ids", "vk_d")
    got = ops.sweep_merge(*(_t(c[key]) for key in keys), 4)
    # the JAX reference scatters the merged rows into copies of the tables;
    # the port's K2 tile returns them, row i for verts[i]
    want = jref.sweep_merge_ref(*(_j(c[key]) for key in keys), k=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[c["verts"]])


def test_poisoned_frontier_relax_equals_jax_ref(cases):
    c = cases["frontier_relax"]
    keys = ("nbr", "rows", "w", "dist", "kth", "src")
    got = ops.frontier_relax(*(_t(c[key]) for key in keys))
    # the JAX reference scatters the receivers' rows into a copy of dist
    want = jref.frontier_relax_ref(*(_j(c[key]) for key in keys))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32)[c["rows"]])


def test_poisoned_frontier_relax_rows_equals_jax_ref(cases):
    # the fused entry reads receiver i's schedule from row rows[i] of the
    # bucket tables: the JAX reference on the gathered rows, plus the mask
    c = cases["frontier_relax_rows"]
    rows = c["rows"]
    tile, changed = ops.frontier_relax_rows(*(_t(c[key]) for key in (
        "nbr_tab", "w_tab", "rows", "dist", "kth", "src")))
    want = np.asarray(jref.frontier_relax_ref(
        _j(c["nbr_tab"][rows]), _j(rows), _j(c["w_tab"][rows]), _j(c["dist"]), _j(c["kth"]),
        _j(c["src"])), np.float32)[rows]
    np.testing.assert_array_equal(tile.numpy(), want)
    np.testing.assert_array_equal(changed.numpy(), (want < c["dist"][rows]).any(axis=1))


def test_poisoned_sweep_merge_levels_equals_jax_ref_level_by_level(cases):
    c = cases["sweep_merge_levels"]
    ids, d = _t(c["vk_ids"]), _t(c["vk_d"])
    buckets = [tuple(_t(x) for x in b) for b in c["buckets"]]
    ops.sweep_merge_levels(buckets, _t(c["levels"]), _t(c["ex_ids"]), _t(c["ex_d"]), ids, d, 4)
    # the JAX reference, one level at a time, scattered into the table
    j_ids, j_d = np.array(c["vk_ids"]), np.array(c["vk_d"])
    n = j_ids.shape[0] - 1
    for bid, off, size in c["levels"]:
        nbr, w, verts = (x[off:off + size] for x in c["buckets"][bid])
        m_ids, m_d = jref.sweep_merge_ref(_j(nbr), _j(verts), _j(w), _j(c["ex_ids"]),
                                          _j(c["ex_d"]), _j(j_ids), _j(j_d), k=4)
        real = verts[verts != n]  # padded rows (verts == n) are not stored
        j_ids[real] = np.asarray(m_ids)[real]
        j_d[real] = np.asarray(m_d)[real]
    np.testing.assert_array_equal(ids.numpy(), j_ids)
    np.testing.assert_array_equal(d.numpy(), j_d)
    assert j_d[-1, 0] == np.float32(7e7)  # the dummy row's trap was never written


def test_poisoned_rows_purge_merge_equals_jax_ops(cases):
    c = cases["rows_purge_merge"]
    ids, d = _t(c["vk_ids"]), _t(c["vk_d"])
    ops.rows_purge_merge(ids, d, *(_t(c[key]) for key in ("rows", "del_ids", "cand_ids",
                                                          "cand_d")), 4)
    j_ids, j_d = jops.rows_purge_merge(*(_j(c[key]) for key in (
        "vk_ids", "vk_d", "rows", "del_ids", "cand_ids", "cand_d")), 4, use_pallas=False)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(d.numpy(), np.asarray(j_d))


def test_kernel_aliasing_on_cpu():
    cells = sanitize.check_kernel_aliasing(device="cpu")
    assert set(cells) == {"sweep_merge", "frontier_relax", "frontier_relax_rows",
                          "sweep_merge_levels", "rows_purge_merge"}
    assert all(v > 0 for v in cells.values())


def test_kernel_aliasing_catches_a_write_outside_the_batch(monkeypatch):
    # a purge+merge that also writes the dummy row: the replay must say so
    real = ops.rows_purge_merge

    def leaky(vk_ids, vk_d, rows, *args, **kwargs):
        out = real(vk_ids, vk_d, rows, *args, **kwargs)
        vk_d[-1] = 0.0
        return out

    monkeypatch.setattr(ops, "rows_purge_merge", leaky)
    with pytest.raises(SanitizerError, match="rows_purge_merge wrote rows outside its batch"):
        sanitize.check_kernel_aliasing(device="cpu")


def test_membership_without_isin_matches_isin():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-1, 500, (300, 7)).astype(np.int32))
    for ids in (np.array([3], np.int32), rng.integers(0, 500, 400).astype(np.int32),
                np.empty(0, np.int32)):
        ids = torch.from_numpy(ids)
        assert torch.equal(ops.member(x, ids), torch.isin(x, ids))
        assert torch.equal(ops.member(x[:, 1:], ids), torch.isin(x[:, 1:], ids))


# ---------------------------------------------------------------------------
# sanitizer mode on a small engine (the JAX test's 8 x 8 grid)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    g = road_network(8, 8, seed=3)
    objects = pick_objects(g.n, 0.2, seed=3)
    jbn = jknn.build_bngraph(g)
    bn = bngraph_from_arrays(**{f.name: getattr(jbn, f.name) for f in dataclasses.fields(jbn)})
    je = jknn.QueryEngine.from_index(knn_index_cons_plus(jbn, objects, k=4), objects, bn=jbn)
    ids, d = (np.array(t) for t in je.tables)
    obj_set = set(int(v) for v in np.asarray(objects).ravel())

    def port(layout="scalar"):
        # fresh copies: a CPU engine's tables may share the arrays' memory
        if layout == "scalar":
            return QueryEngine(ids.copy(), d.copy(), 4, objects, bn=bn, device="cpu")
        plan, _, halo = layout.partition(",")
        te = ShardedQueryEngine(ids.copy(), d.copy(), 4, objects, bn=bn, plan=plan,
                                device="cpu")
        te.halo = halo or "collective"
        return te

    return {"g": g, "objects": objects, "jbn": jbn, "bn": bn, "jax": je, "port": port,
            "ins": [v for v in range(g.n) if v not in obj_set][:4],
            "dels": sorted(obj_set)[:2]}


def _script(g, objects, rng):
    """Five flushes: inserts + deletes, their undo, moves, then mixed random."""
    obj = set(int(v) for v in np.asarray(objects).ravel())
    absent = [v for v in range(g.n) if v not in obj]
    ins, dels = absent[:4], sorted(obj)[:2]
    yield [("ins", v) for v in ins] + [("del", v) for v in dels]
    yield [("del", v) for v in ins] + [("ins", v) for v in dels]
    yield [("mov", sorted(obj)[2], absent[5]), ("mov", sorted(obj)[3], absent[6])]
    obj = (obj - {sorted(obj)[2], sorted(obj)[3]}) | {absent[5], absent[6]}
    for _ in range(2):
        ops_ = []
        for v in rng.choice(g.n, 10, replace=False).tolist():
            ops_.append(("del", v) if v in obj else ("ins", v))
            obj ^= {v}
        yield ops_


def _stage(engine, ops_):
    for op in ops_:
        {"ins": engine.stage_insert, "del": engine.stage_delete,
         "mov": engine.stage_move}[op[0]](*op[1:])


@pytest.mark.parametrize("layout", ["scalar", "shards=2", "shards=4", "shards=4,host"])
def test_sanitizer_mode_tables_equal_jax_after_every_flush(small, monkeypatch, layout):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    g, objects = small["g"], small["objects"]
    je = jknn.QueryEngine.from_index(knn_index_cons_plus(small["jbn"], objects, k=4), objects,
                                     bn=small["jbn"])
    te = small["port"](layout)
    for ops_ in _script(g, objects, np.random.default_rng(5)):
        _stage(je, ops_)
        _stage(te, ops_)
        want = je.flush_updates()
        assert te.flush_updates() == want
        j_ids, j_d = je._host_tables()
        t_ids, t_d = te._host_tables()
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_array_equal(t_d, j_d)


@pytest.mark.parametrize("layout", ["scalar", "shards=2"])
def test_corrupt_table_fails_the_post_flush_scan(small, monkeypatch, layout):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    te = small["port"](layout)
    tables = te.tables if layout == "scalar" else (te._ids_g, te._d_g)
    # a NaN in a row the flush does not touch: it rides into the next epoch
    far = int(np.asarray(small["g"].n)) - 1
    row = far if layout == "scalar" else int(te._g_of_v[far])
    tables[1][row, 1] = float("nan")
    te.stage_insert(small["ins"][0])
    with pytest.raises(SanitizerError) as got:
        te.flush_updates()
    ids, d = te._host_tables()
    with pytest.raises(JaxSanitizerError) as want:
        jsanitize.scan_tables(ids, d, te.n, context="flush -> epoch 1")
    assert str(got.value) == str(want.value)
    assert "1 NaN distances" in str(got.value)


# ---------------------------------------------------------------------------
# repair: the scalar engine's out-of-range query ids
# ---------------------------------------------------------------------------


def test_scalar_query_ids_out_of_range_match_jax(small):
    je, te = small["jax"], small["port"]()
    n = te.n
    us = np.array([n + 5, -1, -(n + 1), -(n + 7), n, 0, n - 1, -2], np.int32)
    for k in (None, np.array([4, 1, 2, 3, 4, 4, 1, 2], np.int32)):
        ids, d = te.query_batch(us, k)
        j_ids, j_d = je.query_batch(us, k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(d.numpy(), np.asarray(j_d))
