"""K4 ``minplus`` (plain PyTorch version, on the CPU) and the BN-Graph
certificate, held against the JAX package: its pure-jnp oracle
(``repro.kernels.ref.minplus_matmul_ref``), its Pallas kernel in interpret
mode (``repro.kernels.ops.minplus_matmul`` with use_pallas=True) and
``repro.core.verify``.

Inputs are made with numpy from a seed and fed to both sides. Tolerance:
exact (``array_equal``, NaN equal to NaN). Each term is one float32 add and
min has no order to differ in, so nothing rounds differently. The CUDA kernel
itself cannot run without a GPU; ``chip_smoke.py`` holds it against this same
plain version on the card.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bngraph import build_bngraph as jax_build_bngraph
from repro.core.verify import bngraph_dense_adjacency as jax_dense_adjacency
from repro.core.verify import certificate as jax_certificate
from repro.core.verify import relaxation_stable as jax_relaxation_stable
from repro.graph import generators as jgen
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.bngraph import build_bngraph
from repro_torch.core.verify import (
    bngraph_dense_adjacency,
    certificate,
    rank_consistent,
    relaxation_stable,
)
from repro_torch.graph import generators
from repro_torch.kernels import ops, ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(32, 32, 32), (70, 90, 130), (128, 256, 128)]


def _case(m, k, n, seed, inf_frac=0.0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 50, size=(m, k)).astype(np.float32)
    b = rng.uniform(0, 50, size=(k, n)).astype(np.float32)
    a[rng.random((m, k)) < inf_frac] = np.inf
    b[rng.random((k, n)) < inf_frac] = np.inf
    return a, b


def _jax_ref(a, b):
    return np.asarray(jref.minplus_matmul_ref(jnp.asarray(a), jnp.asarray(b)))


def _torch_minplus(a, b, **kw):
    out = ops.minplus_matmul(torch.from_numpy(a), torch.from_numpy(b), **kw)
    assert out.dtype == torch.from_numpy(a).dtype
    return out.numpy()


# ---------------------------------------------------------------------------
# minplus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("inf_frac", [0.0, 0.4])
def test_minplus_matches_jax_ref(m, k, n, inf_frac):
    a, b = _case(m, k, n, m + k + n, inf_frac)
    got = _torch_minplus(a, b)
    np.testing.assert_array_equal(got, _jax_ref(a, b))
    plain = ref.minplus_matmul_ref(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(plain.numpy(), got)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_minplus_matches_pallas_interpret(m, k, n):
    a, b = _case(m, k, n, 7 * m + n, 0.2)
    want = jops.minplus_matmul(jnp.asarray(a), jnp.asarray(b), block_m=32, block_n=64, block_k=32)
    np.testing.assert_array_equal(_torch_minplus(a, b), np.asarray(want))


def test_minplus_with_inf_padding():
    a = np.full((8, 8), np.inf, np.float32)
    a[0, 0] = 1.0
    b = np.full((8, 8), np.inf, np.float32)
    b[0, 0] = 2.0
    got = _torch_minplus(a, b)
    assert got[0, 0] == 3.0 and np.isinf(got[1:]).all() and np.isinf(got[0, 1:]).all()
    want = jops.minplus_matmul(jnp.asarray(a), jnp.asarray(b), block_m=8, block_n=8, block_k=8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_minplus_one_nan_spreads_along_its_row_as_in_jax():
    a, b = _case(40, 33, 50, 3, 0.3)
    a[6, 11] = np.nan
    got = _torch_minplus(a, b)
    assert np.isnan(got[6]).all() and np.isnan(got).sum() == got.shape[1]
    np.testing.assert_array_equal(got, _jax_ref(a, b))
    want = jops.minplus_matmul(jnp.asarray(a), jnp.asarray(b), block_m=8, block_n=64, block_k=8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_minplus_float16_math_in_float32_output_in_input_type():
    a, b = _case(24, 40, 36, 5, 0.2)
    a16, b16 = a.astype(np.float16), b.astype(np.float16)
    got = _torch_minplus(a16, b16)
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got, _jax_ref(a16, b16))


@pytest.mark.parametrize("budget", [4 * 36, 4 * 36 * 5, 4 * 36 * 40 * 3])
def test_minplus_chunks_give_the_same_values(budget, monkeypatch):
    """The plain version walks row and t chunks under a temporary budget; any
    budget gives the unchunked values (here: t chunks of 1 and 5 rows of one,
    and whole-t chunks of 3 rows)."""
    a, b = _case(23, 40, 36, 9, 0.3)
    a[4, 7] = np.nan
    whole = ref.minplus_matmul_ref(torch.from_numpy(a), torch.from_numpy(b))
    monkeypatch.setattr(ref, "_MINPLUS_TEMP_BYTES", budget)
    part = ref.minplus_matmul_ref(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(part.numpy(), whole.numpy())


def test_minplus_rejects_shapes_that_do_not_chain():
    with pytest.raises(ValueError, match="do not chain"):
        ops.minplus_matmul(torch.zeros(3, 4), torch.zeros(5, 2))


def test_minplus_on_cpu_tensors_counts_no_launch():
    ops.reset_launches()
    a, b = _case(16, 16, 16, 0)
    _torch_minplus(a, b)
    _torch_minplus(a, b, use_kernel=False)
    assert ops.launches()["minplus"] == 0


# ---------------------------------------------------------------------------
# minplus: the kernel's slice bits and pair walk, emulated in plain torch
# ---------------------------------------------------------------------------


def _inert(x, y, predicate="kernel"):
    """Which (A slice, B slice) pairs K4 skips. ``"all_pinf_only"`` is the
    wrong predicate a kernel must not use: it skips +inf facing NaN or -inf."""
    ap, aq = (x & ref.SLICE_ALL_PINF) > 0, (x & ref.SLICE_POISON) > 0
    bp, bq = (y & ref.SLICE_ALL_PINF) > 0, (y & ref.SLICE_POISON) > 0
    if predicate == "all_pinf_only":
        return ap | bp
    return (ap & ~bq) | (bp & ~aq)


def _pair_walk(a, b, tile, depth, predicate="kernel"):
    """K4's algorithm on the CPU: the slice bits, then for each output tile the
    min over its live t slices only; a tile with none stays +inf. Returns the
    product and the number of (tile, t slice) pairs walked."""
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    a_bits, b_bits = ref.minplus_slice_bits(at, bt, tile, depth)
    m, kd = a.shape
    n = b.shape[1]
    out = torch.full((m, n), np.inf, dtype=torch.float32)
    walked = 0
    for rb in range(a_bits.shape[0]):
        for cb in range(b_bits.shape[1]):
            live = torch.nonzero(~_inert(a_bits[rb], b_bits[:, cb], predicate)).flatten()
            walked += live.numel()
            if not live.numel():
                continue
            ts = torch.cat([torch.arange(t * depth, min(kd, (t + 1) * depth)) for t in live])
            rows, cols = slice(rb * tile, (rb + 1) * tile), slice(cb * tile, (cb + 1) * tile)
            part = at[rows][:, ts, None] + bt[ts][:, cols][None]
            out[rows, cols] = torch.amin(part, dim=1)
    return out.numpy(), walked


def _block_sparse(m, k, n, tile, depth, seed):
    """+inf almost everywhere, a third of the slices holding finite entries,
    and the traps: an all-+inf A slice facing a B slice with one -inf, another
    facing a B slice with one NaN, an A slice with a single finite entry, and
    edges no tile or slice divides (the caller's shapes)."""
    rng = np.random.default_rng(seed)
    a = np.full((m, k), np.inf, np.float32)
    b = np.full((k, n), np.inf, np.float32)
    for x, (sr, sc) in ((a, (tile, depth)), (b, (depth, tile))):
        for r0 in range(0, x.shape[0], sr):
            for c0 in range(0, x.shape[1], sc):
                if rng.random() < 0.33:
                    blk = x[r0 : r0 + sr, c0 : c0 + sc]
                    fill = rng.random(blk.shape) < 0.3
                    blk[fill] = rng.integers(0, 40, size=int(fill.sum()))
    # trap 1: A slice (row block 0, t slice 1) all +inf; B slice (1, column block 0) one -inf
    a[:tile, depth : 2 * depth] = np.inf
    b[depth + 1, 3] = -np.inf
    # trap 2: A slice (1, 2) all +inf; B slice (2, column block 1) one NaN
    a[tile : 2 * tile, 2 * depth : 3 * depth] = np.inf
    b[2 * depth + 2, tile + 5] = np.nan
    # a single finite entry in A slice (2, 0)
    a[2 * tile : 3 * tile, :depth] = np.inf
    a[2 * tile + 7, 3] = 1.5
    return a, b


@pytest.mark.parametrize("tile,depth,shape", [
    (8, 4, (29, 23, 31)), (16, 8, (53, 41, 37)), (128, 32, (300, 97, 270)),
])
def test_minplus_pair_walk_matches_jax_ref(tile, depth, shape):
    a, b = _block_sparse(*shape, tile, depth, seed=sum(shape))
    want = _jax_ref(a, b)
    got, walked = _pair_walk(a, b, tile, depth)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(want).any() and (want == -np.inf).any() and np.isfinite(want).any()
    # the traps are live: skipping on all-+inf alone loses the NaN / -inf terms
    wrong, skipped_more = _pair_walk(a, b, tile, depth, "all_pinf_only")
    assert not np.array_equal(wrong, want) and skipped_more < walked
    # the live count the wrapper orders tiles by, and the count a product walks
    bits = ref.minplus_slice_bits(torch.from_numpy(a), torch.from_numpy(b), tile, depth)
    assert int(ref.minplus_live_counts(*bits).sum()) == walked
    n_slices = -(-shape[1] // depth)
    assert walked < -(-shape[0] // tile) * -(-shape[2] // tile) * n_slices


def test_minplus_slice_bits_count_ragged_edges_as_pinf():
    a = np.full((10, 9), np.inf, np.float32)
    a[9, 8] = -np.inf                    # poison in the last, ragged slice
    a[0, 0] = np.nan
    b = np.full((9, 5), np.inf, np.float32)
    b[8, 4] = 2.0
    a_bits, b_bits = ref.minplus_slice_bits(torch.from_numpy(a), torch.from_numpy(b), 8, 4)
    assert a_bits.tolist() == [[2, 1, 1], [1, 1, 2]]
    assert b_bits.tolist() == [[1], [1], [0]]


def test_minplus_pairs_on_the_cpu_count_the_live_pairs():
    a, b = _block_sparse(300, 97, 270, 128, 32, seed=1)
    pairs = torch.zeros(1, dtype=torch.int64)
    got = ops.minplus_matmul(torch.from_numpy(a), torch.from_numpy(b), pairs=pairs)
    np.testing.assert_array_equal(got.numpy(), _jax_ref(a, b))
    assert int(pairs) == _pair_walk(a, b, 128, 32)[1]


def test_minplus_pair_walk_on_the_grid10_adjacency_matches_jax():
    jbn = jax_build_bngraph(jgen.road_network(10, 10, seed=0))
    a = np.asarray(jax_dense_adjacency(jbn))
    want = jops.minplus_matmul(jnp.asarray(a), jnp.asarray(a), block_m=32, block_n=32,
                               block_k=32)
    np.testing.assert_array_equal(a, bngraph_dense_adjacency(
        build_bngraph(generators.road_network(10, 10, seed=0))))
    for tile, depth in ((128, 32), (16, 8)):
        got, walked = _pair_walk(a, a, tile, depth)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got, _jax_ref(a, a))


@pytest.mark.parametrize("fault", ["intact", "minplus_pinf_only", "sweep_no_barrier"])
def test_k2_k4_planted_faults_apply_to_the_kernels(fault, tmp_path):
    """Each planted fault of tools/k2_k4_planted_faults.py finds its text in
    its kernel's source once, and edits only the copy."""
    spec = importlib.util.spec_from_file_location(
        "k2_k4_planted_faults", os.path.join(REPO, "tools", "k2_k4_planted_faults.py"))
    pf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pf)
    source, edits, must_fail = pf.FAULTS[fault]
    assert (must_fail is None) == (fault == "intact") and must_fail in (None, *pf.CHECKS)
    for name in ("minplus.cu", "sweep_merge.cu"):
        os.makedirs(tmp_path / pf.CSRC, exist_ok=True)
        (tmp_path / pf.CSRC / name).write_text(open(os.path.join(REPO, pf.CSRC, name)).read())
    pf.plant(str(tmp_path), source, edits)
    for name in ("minplus.cu", "sweep_merge.cu"):
        original = open(os.path.join(REPO, pf.CSRC, name)).read()
        planted = (tmp_path / pf.CSRC / name).read_text()
        assert (planted == original) == (name != source)
        assert planted.count("planted fault") == (name == source)


# ---------------------------------------------------------------------------
# the certificate
# ---------------------------------------------------------------------------


RANDOM_CASES = [(5, 0, 0), (12, 8, 1), (20, 15, 3), (27, 30, 11), (35, 40, 123), (18, 2, 999)]


def _graph_pair(kind, *args):
    if kind == "road":
        a, b, seed = args
        return jgen.road_network(a, b, seed=seed), generators.road_network(a, b, seed=seed)
    n, extra, seed = args
    return (jgen.random_connected_graph(n, extra_edges=extra, seed=seed),
            generators.random_connected_graph(n, extra_edges=extra, seed=seed))


CERT_CASES = [("random", *c) for c in RANDOM_CASES] + [("road", 9, 11, 0), ("road", 14, 14, 2)]


@pytest.mark.parametrize("case", CERT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_certificate_matches_jax(case):
    jg, g = _graph_pair(*case)
    jbn, bn = jax_build_bngraph(jg), build_bngraph(g)
    np.testing.assert_array_equal(bngraph_dense_adjacency(bn), jax_dense_adjacency(jbn))
    assert bngraph_dense_adjacency(bn).dtype == np.float32
    cert = certificate(bn, device="cpu")
    assert cert == jax_certificate(jbn, use_pallas=False)
    assert cert == {"relaxation_stable": True, "rank_consistent": True, "ok": True}
    assert certificate(bn, device="cpu", use_kernel=False) == cert


def test_certificate_catches_corruption_as_jax_does():
    jg, g = _graph_pair("random", 20, 15, 3)
    jbn, bn = jax_build_bngraph(jg), build_bngraph(g)
    assert relaxation_stable(bn, device="cpu") and jax_relaxation_stable(jbn, use_pallas=False)
    # corrupt one edge weight upward -> a shorter two-hop path now exists
    for graph in (jbn, bn):
        for v in range(graph.n):
            sel = graph.lo_ids[v] >= 0
            if sel.sum() >= 2:
                graph.lo_w[v][np.argmax(sel)] += 100.0
                break
    np.testing.assert_array_equal(bngraph_dense_adjacency(bn), jax_dense_adjacency(jbn))
    assert not relaxation_stable(bn, device="cpu")
    assert not jax_relaxation_stable(jbn, use_pallas=False)
    assert certificate(bn, device="cpu") == jax_certificate(jbn, use_pallas=False)
    assert certificate(bn, device="cpu")["ok"] is False


def test_rank_check_catches_a_swapped_rank():
    _, g = _graph_pair("road", 8, 8, 1)
    bn = build_bngraph(g)
    assert rank_consistent(bn)
    v = int(np.flatnonzero((bn.lo_ids >= 0).any(axis=1))[0])
    u = int(bn.lo_ids[v][bn.lo_ids[v] >= 0][0])
    bn.rank[u], bn.rank[v] = bn.rank[v], bn.rank[u]
    assert not rank_consistent(bn)
    assert certificate(bn, device="cpu")["ok"] is False


def test_certificate_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    bn = build_bngraph(generators.road_network(5, 5, seed=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        certificate(bn)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        relaxation_stable(bn)
