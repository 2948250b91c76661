"""The port's recsys path on the CPU, held against the JAX package: K5
``retrieval_topk`` (plain version) against the JAX kernel path, the xDeepFM
modules with parameters carried across by ``params_from_numpy``, the data
streams, and the retrieval example's command line.

Inputs are made with numpy from a seed and fed to both sides. Tolerances:
- ``retrieval_topk``: exact (``array_equal`` on ids and scores); it only
  compares and copies.
- embeddings: rtol 1e-6 (a gather and a sum of at most three terms).
- CIN, forward logits, retrieval scores: rtol 1e-5 / atol 1e-6 (float32 sums
  over up to H*F terms in another order); retrieval ids equal wherever the
  true scores of neighbouring ranks differ by more than 1e-8.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.kernels import ops as jops
from repro.models import recsys as jrc
from repro_torch.configs import xdeepfm
from repro_torch.data import pipeline
from repro_torch.examples import retrieval_recsys
from repro_torch.kernels import ops, ref
from repro_torch.models import recsys as rc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
RTOL, ATOL = 1e-5, 1e-6


# ---------------------------------------------------------------------------
# K5 retrieval_topk against the JAX kernel path (Pallas, interpret mode)
# ---------------------------------------------------------------------------


def _scores(case, b, n, seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n)).astype(np.float32)
    if case == "ties":
        s = np.round(s, 1)
    elif case == "neg_inf":
        s[0, ::3] = -np.inf
        s[-1] = -np.inf
        if b > 2:
            s[1, 5:] = -np.inf  # fewer finite scores than k
    return s


def _jax_topk(s, k, dtype):
    x = jnp.asarray(s).astype(dtype)
    ji, jd = jops.retrieval_topk(x, k, use_pallas=True)
    return np.asarray(ji), np.asarray(jd.astype(jnp.float32))


@pytest.mark.parametrize("b,n,k", [(1, 1024, 5), (8, 10000, 16), (3, 4096, 100)])
@pytest.mark.parametrize("case", ["plain", "ties", "neg_inf"])
def test_retrieval_topk_matches_jax_kernel_path(b, n, k, case):
    s = _scores(case, b, n, b * n)
    ti, td = ops.retrieval_topk(torch.from_numpy(s), k)
    ji, jd = _jax_topk(s, k, jnp.float32)
    assert tuple(ti.shape) == (b, k) and ti.dtype == torch.int32 and td.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(td.numpy(), jd)


@pytest.mark.parametrize("n,k", [(7, 20), (50, 64), (1, 3)])
def test_retrieval_topk_fewer_columns_than_k_pads(n, k):
    s = _scores("plain", 3, n, n)
    ti, td = ops.retrieval_topk(torch.from_numpy(s), k)
    ji, jd = _jax_topk(s, k, jnp.float32)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(td.numpy(), jd)
    assert (ti.numpy()[:, n:] == -1).all() and np.isneginf(td.numpy()[:, n:]).all()


@pytest.mark.parametrize("tdt,jdt", [(torch.float16, jnp.float16),
                                     (torch.bfloat16, jnp.bfloat16)])
def test_retrieval_topk_narrow_types(tdt, jdt):
    s = _scores("ties", 4, 3000, 3)
    s[2, ::5] = -np.inf
    x = torch.from_numpy(s).to(tdt)
    ti, td = ops.retrieval_topk(x, 40)
    ji, jd = _jax_topk(s, 40, jdt)
    assert td.dtype == tdt
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(td.float().numpy(), jd)


def test_retrieval_topk_worked_example_and_negative_zero():
    s = np.array([[3, -np.inf, 1, 3, -np.inf, 0.5], [0.0, -0.0, 0.0, -1, 2, -0.0]], np.float32)
    ti, td = ops.retrieval_topk(torch.from_numpy(s), 6)
    np.testing.assert_array_equal(ti.numpy()[0], [0, 3, 2, 5, -1, -1])
    np.testing.assert_array_equal(ti.numpy()[1], [4, 0, 1, 2, 5, 3])
    assert not np.signbit(td.numpy()[1, 1:5]).any()  # -0.0 reads as +0.0
    ji, jd = _jax_topk(s, 6, jnp.float32)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(td.numpy(), jd)


def test_retrieval_topk_ref_chunks_rows(monkeypatch):
    """Row chunks (the 1 GiB bound at (512, 10^6)) give the same answer."""
    s = torch.from_numpy(_scores("ties", 9, 2000, 4))
    whole = ref.retrieval_topk_ref(s, 30)
    monkeypatch.setattr(ref, "_TOPK_TEMP_BYTES", 12 * 2000 * 2)
    chunked = ref.retrieval_topk_ref(s, 30)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])


def test_retrieval_topk_refuses_k_past_the_kernel():
    s = torch.zeros((1, 4096))
    with pytest.raises(ValueError, match="1 <= k <= 1024"):
        ops.retrieval_topk(s, 1025)
    with pytest.raises(ValueError, match="1 <= k <= 1024"):
        ops.retrieval_topk(s, 0)
    assert ops.retrieval_topk(s, 1024)[0].shape == (1, 1024)


# ---------------------------------------------------------------------------
# K5's algorithm (parts, theta_lb, filter, select) and its plan, on the CPU
# ---------------------------------------------------------------------------

PARTS_N, PARTS_K = 5000, 24


@functools.lru_cache(maxsize=None)
def _parts_case(case):
    """(scores, JAX kernel-path ids, scores) of one (3, 5000) case, k = 24."""
    s = _scores("ties" if case == "ties" else "neg_inf" if case == "neg_inf" else "plain",
                3, PARTS_N, 17)
    if case == "ascending":
        s = np.tile(np.arange(PARTS_N, dtype=np.float32), (3, 1))
        s[1] = s[1, ::-1]  # descending
        s[2] = np.float32(0.5)  # all equal: only the columns order them
    elif case == "kth_on_boundary":
        edge = -(-PARTS_N // 7)  # the first column of part 1 when P = 7
        s[:, : edge - 1] = np.minimum(s[:, : edge - 1], 4.0)
        s[:, edge + 1 :] = np.minimum(s[:, edge + 1 :], 4.0)
        s[:, edge - 3 * PARTS_K + 2 : edge - 1 : 3] = 10.0 + np.arange(PARTS_K - 1)
        s[:, edge - 1] = s[:, edge] = 5.0  # the k-th key ends part 0, the next starts part 1
    ji, jd = _jax_topk(s, PARTS_K, jnp.float32)
    return s, ji, jd


@pytest.mark.parametrize("parts", [1, 2, 3, 7, 64])
@pytest.mark.parametrize("case", ["plain", "ties", "neg_inf", "ascending", "kth_on_boundary"])
def test_retrieval_topk_parts_ref_matches_jax_kernel_path(case, parts):
    s, ji, jd = _parts_case(case)
    ti, td = ref.retrieval_topk_parts_ref(torch.from_numpy(s), PARTS_K, parts)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(td.numpy(), jd)


def test_retrieval_topk_parts_ref_narrow_types_and_fewer_columns_than_k():
    s = _scores("ties", 4, 3000, 3)
    s[2, ::5] = -np.inf
    x = torch.from_numpy(s).to(torch.bfloat16)
    for parts in (1, 5, 40):
        got = ref.retrieval_topk_parts_ref(x, 40, parts)
        want = ref.retrieval_topk_ref(x, 40)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    short = torch.from_numpy(_scores("plain", 3, 7, 7))
    got = ref.retrieval_topk_parts_ref(short, 20, 3)
    assert torch.equal(got[0], ref.retrieval_topk_ref(short, 20)[0])


SLOTS = 528  # K5's blocks an H100 holds at once (132 SMs x 4)


@pytest.mark.parametrize("b,n,k,want", [
    (1, 1_000_000, 100, 244),   # the retrieval cell: 244 parts of 4,096 columns
    (512, 1_000_000, 100, 1),   # the batched rows: one wave of whole rows
    (1, 1_000_000, 1024, 32),   # k = 1024: the merge's 32,768 keys
    (2, 100_000, 1024, 24),
    (4, 200_000, 100, 48),
    (70_000, 64, 8, 1),         # past the old 65,535-row grid limit
    (1, 50, 64, 1),
    (1, SLOTS * 4096, 16, SLOTS),  # the plan's largest P
])
def test_retrieval_plan_follows_its_rules(b, n, k, want):
    parts = ops.retrieval_plan(b, n, k, SLOTS)
    assert parts == want
    assert parts >= 1
    assert parts == 1 or b * parts <= SLOTS  # one wave
    assert parts == 1 or n // parts >= ops.RETRIEVAL_MIN_PART  # no narrow part
    assert parts == 1 or parts * k <= ops.RETRIEVAL_MERGE_KEYS  # the merge's keys
    assert b * parts < 2**31


def test_retrieval_plan_any_row_count():
    for b in (1, 65_535, 65_536, 2**31 - 1):
        assert ops.retrieval_plan(b, 10**6, 100, SLOTS) * b < 2**31


def _inf_nan_scores(seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((4, 3000)).astype(np.float32)
    s[0, ::97] = np.nan
    s[0, 5::601] = np.inf  # 5 +inf, fewer than k
    s[1, 3::7] = np.inf  # 428 +inf, more than k
    s[1, ::50] = np.nan
    s[2, 1::3] = np.nan
    s[2, 2::11] = np.inf
    s[3] = np.round(s[3], 1)
    s[3, ::13] = np.inf
    return s


@pytest.mark.parametrize("k", [1, 30, 100])
def test_retrieval_topk_inf_nan_matches_jax_oracle(k):
    """+inf and NaN scattered, at least k finite scores a row: the port's
    plain version and K5's mirror equal the JAX package's oracle (the JAX
    kernel path reads +inf as no candidate; ROADMAP Queue C)."""
    from repro.kernels import ref as jref

    s = _inf_nan_scores(k)
    assert (np.isfinite(s).sum(axis=1) >= k).all()
    oi, od = jref.retrieval_topk_ref(jnp.asarray(s), k)
    for ti, td in (ops.retrieval_topk(torch.from_numpy(s), k),
                   ref.retrieval_topk_parts_ref(torch.from_numpy(s), k, 6)):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(oi))
        np.testing.assert_array_equal(td.numpy(), np.asarray(od))


# ---------------------------------------------------------------------------
# xDeepFM modules, parameters carried across
# ---------------------------------------------------------------------------

MEDIUM = dict(name="xdeepfm-medium", n_sparse=12, embed_dim=8, table_rows=5000,
              cin_layers=(32, 24, 16), mlp_layers=(64, 32), multi_hot_fields=3, bag_size=3)


def _configs(which):
    if which == "smoke":
        from repro.configs import xdeepfm as jcfg

        return jcfg.make_smoke(), xdeepfm.make_smoke()
    return jrc.XDeepFMConfig(**MEDIUM), rc.XDeepFMConfig(**MEDIUM)


def _model(which, seed=0):
    jcfg, tcfg = _configs(which)
    jparams = jrc.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = rc.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(cfg, b, step=0):
    stream = pipeline.RecsysStream(n_sparse=cfg.n_sparse, bag=cfg.bag_size,
                                   rows=cfg.table_rows, batch=b,
                                   multi_hot_fields=cfg.multi_hot_fields)
    return stream.batch_at(step)


def test_embedding_bag_matches_jax():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((40, 6)).astype(np.float32)
    idx = rng.integers(-1, 40, size=(17, 4)).astype(np.int32)
    for mode in ("sum", "mean"):
        got = rc.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx), mode=mode)
        want = jrc.embedding_bag(jnp.asarray(table), jnp.asarray(idx), mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    flat = rng.integers(0, 40, size=50).astype(np.int32)
    bags = np.sort(rng.integers(0, 9, size=50)).astype(np.int32)
    got = rc.embedding_bag_ragged(torch.from_numpy(table), torch.from_numpy(flat),
                                  torch.from_numpy(bags), 9)
    want = jrc.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat), jnp.asarray(bags), 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("which", ["smoke", "medium"])
def test_embed_fields_and_cin_match_jax(which, monkeypatch):
    jcfg, tcfg, jparams, tparams = _model(which)
    batch = _batch(tcfg, 33)
    jemb, jlin = jrc._embed_fields(jparams, {"sparse_ids": jnp.asarray(batch["sparse_ids"])}, jcfg)
    temb, tlin = rc._embed_fields(tparams, torch.from_numpy(batch["sparse_ids"]))
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tlin.numpy(), np.asarray(jlin), rtol=1e-6, atol=1e-9)
    want = np.asarray(jrc._cin(jparams, jemb, jcfg))
    got = rc._cin(tparams, temb, tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the batch in chunks of a few rows (the serve_bulk bound): the same
    # values up to the product's summation order, which follows its shape
    monkeypatch.setattr(rc, "_CIN_TEMP_BYTES", 5 * max(tcfg.cin_layers) * tcfg.n_sparse
                        * tcfg.embed_dim * 4)
    np.testing.assert_allclose(rc._cin(tparams, temb, tcfg).numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ["smoke", "medium"])
def test_forward_matches_jax(which):
    jcfg, tcfg, jparams, tparams = _model(which, seed=3)
    for step, b in ((0, 16), (1, 129)):
        batch = _batch(tcfg, b, step)
        want = jrc.forward(jparams, {"sparse_ids": jnp.asarray(batch["sparse_ids"])}, jcfg)
        got = rc.forward(tparams, batch, tcfg, device="cpu")
        assert tuple(got.shape) == (b,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which,k", [("smoke", 10), ("medium", 100)])
def test_retrieval_score_matches_jax(which, k):
    jcfg, tcfg, jparams, tparams = _model(which, seed=5)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, tcfg.table_rows, (1, tcfg.n_sparse, tcfg.bag_size)).astype(np.int32)
    n = tcfg.table_rows
    ji, jd = jrc.retrieval_score(jparams, {"sparse_ids": jnp.asarray(ids), "n_candidates": n},
                                 jcfg, k=k)
    ti, td = rc.retrieval_score(tparams, {"sparse_ids": ids, "n_candidates": n}, tcfg, k=k,
                                device="cpu")
    assert tuple(ti.shape) == (1, k)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=1e-9)
    # true scores in float64: ranks whose score is clear of both neighbours
    # by 1e-8 must name the same item on both sides
    emb = np.asarray(jparams["tables"], np.float64)
    q = sum(emb[f, ids[0, f, j]] for f in range(tcfg.n_sparse) for j in range(tcfg.bag_size)
            if ids[0, f, j] >= 0)
    true = np.sort(emb[0, :n] @ q)[::-1][: k + 1]
    gap = np.minimum(np.abs(np.diff(true, prepend=np.inf))[:k], np.abs(np.diff(true))[:k])
    clear = gap > 1e-8
    assert clear.sum() >= k // 2
    np.testing.assert_array_equal(ti.numpy()[0][clear], np.asarray(ji)[0][clear])


def test_recsys_streams_match_jax():
    for kw in (dict(n_sparse=39, bag=3, rows=1_000_000, batch=64),
               dict(n_sparse=6, bag=2, rows=64, batch=5, multi_hot_fields=2, seed=7)):
        ours, theirs = pipeline.RecsysStream(**kw), jpipe.RecsysStream(**kw)
        for step in (0, 3):
            a, b = ours.batch_at(step), theirs.batch_at(step)
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


def test_xdeepfm_config_and_cells():
    from repro.configs import xdeepfm as jcfg
    from repro.configs.common import recsys_shapes

    ours, theirs = xdeepfm.make_config(), jcfg.make_config()
    for field in ("n_sparse", "embed_dim", "table_rows", "cin_layers", "mlp_layers",
                  "multi_hot_fields", "bag_size"):
        assert getattr(ours, field) == getattr(theirs, field)
    shapes = recsys_shapes(39, 3)
    assert shapes["serve_p99"].specs(None)["sparse_ids"].shape[0] == xdeepfm.SERVE_P99_BATCH
    assert shapes["serve_bulk"].specs(None)["sparse_ids"].shape[0] == xdeepfm.SERVE_BULK_BATCH
    assert shapes["retrieval_cand"].specs(None)["n_candidates"] == xdeepfm.RETRIEVAL_CANDIDATES


# ---------------------------------------------------------------------------
# entry points: the example, and the device rule
# ---------------------------------------------------------------------------


def test_retrieval_example_cli_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.retrieval_recsys", "--device", "cpu",
         "--candidates", "30000", "--k", "25"],
        capture_output=True, text=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=SRC),
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("top-25 of 30,000 candidates in")
    assert lines[3] == "plain version agrees with plain version: True"
    stats = json.loads(lines[-1])
    assert stats["agrees"] is True and stats["device"] == "cpu"
    assert stats["launches"]["retrieval_topk"] == 0


def test_recsys_entry_points_raise_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    cfg = xdeepfm.make_smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rc.init_params(cfg)
    params = rc.init_params(cfg, device="cpu")
    batch = {"sparse_ids": _batch(cfg, 1)["sparse_ids"], "n_candidates": 64}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rc.retrieval_score(params, batch, cfg, k=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rc.forward(params, batch, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        retrieval_recsys.main(["--candidates", "1000"])
    ids, _ = rc.retrieval_score(params, batch, cfg, k=5, device="cpu")
    assert tuple(ids.shape) == (1, 5)


def test_serve_refuses_the_recsys_family():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="retrieval_recsys"):
        serve.main(["--arch", "xdeepfm", "--device", "cpu"])
