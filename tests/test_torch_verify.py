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
