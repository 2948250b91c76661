"""The port's cell catalogue and its serving step factories on the CPU, held
against the JAX package.

The catalogue: ``registry.all_cells(include_skipped=True)`` against the JAX
registry's, pair for pair: the same (arch, shape) pairs, kind, skip reason,
and every input spec's shape and dtype (jnp -> torch) or size.

The factories, each against the JAX factory it ports, run jitted on the 1 x 1
host mesh (``make_rules(make_host_mesh())``): ``make_knn_build`` (scatter
and contiguous forms) and ``make_knn_serve`` at the kNN smoke config over a
16 x 16 road network's index, exact; ``make_recsys_forward`` and
``make_recsys_retrieval`` at xdeepfm's smoke config, and ``make_lm_prefill``
with ``make_lm_decode`` (qwen2.5-3b and granite-moe smoke configs, a few
decode steps), with the parameters carried over by ``params_from_numpy``, at
rtol = atol = 1e-5 (float32 products and reductions summed in other orders
by the two frameworks, ~1e-6 at these sizes). Retrieval ids are compared
where the scores are clear of their neighbours by 1e-6: the JAX factory
takes ``lax.top_k`` and the port K5's plain version, whose orders may part
at a near-tie. Every factory refuses to run without a card unless
``device="cpu"`` is passed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.knn_index import make_smoke as jknn_smoke
from repro.core.bngraph import build_bngraph
from repro.core.reference import knn_index_cons_plus
from repro.distributed.sharding import make_rules
from repro.graph.generators import pick_objects, road_network
from repro.launch.mesh import make_host_mesh
from repro.models import recsys as jrc
from repro.models import transformer as jtr
from repro.train import steps as jsteps
from repro_torch.configs import knn_index, registry
from repro_torch.data import pipeline
from repro_torch.models import recsys as rc
from repro_torch.models import transformer as tr
from repro_torch.train import steps

TOL = 1e-5
GAP = 1e-6


@pytest.fixture(scope="module")
def rules():
    return make_rules(make_host_mesh())


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=err_msg)


# ---------------------------------------------------------------------------
# the catalogue
# ---------------------------------------------------------------------------


def _jax_cfg(arch, shape):
    return arch.make_config(shape) if arch.family == "gnn" else arch.make_config()


@pytest.mark.parametrize("arch_id", sorted(jregistry._ARCHS))
def test_cells_match_jax(arch_id):
    jarch, arch = jregistry.get_arch(arch_id), registry.get_arch(arch_id)
    assert arch.family == jarch.family
    assert list(arch.shapes) == list(jarch.shapes)
    for shape, jcell in jarch.shapes.items():
        cell = arch.shapes[shape]
        assert (cell.kind, cell.skip) == (jcell.kind, jcell.skip), shape
        want = jcell.specs(_jax_cfg(jarch, shape))
        got = cell.specs(_jax_cfg(arch, shape))
        assert got.keys() == want.keys(), shape
        for name, spec in want.items():
            if isinstance(spec, int):
                assert got[name] == spec, (shape, name)
            else:
                dims, dtype = got[name]
                assert (dims, str(dtype).removeprefix("torch.")) == (
                    tuple(spec.shape), str(spec.dtype)), (shape, name)


def test_all_cells_count_and_order():
    pairs = lambda cells: [(a.arch_id, shape) for a, shape, _ in cells]
    assert len(registry.all_cells()) == 37 and len(registry.all_cells(include_skipped=True)) == 42
    assert sorted(pairs(registry.all_cells(True))) == sorted(pairs(jregistry.all_cells(True)))
    assert sorted(pairs(registry.all_cells())) == sorted(pairs(jregistry.all_cells()))
    assert sorted(registry.ASSIGNED) == sorted(jregistry.ASSIGNED)
    assert [a.arch_id for a in registry.all_archs()] == list(registry._ARCHS)
    skipped = [(a.arch_id, s) for a, s, c in registry.all_cells(True) if c.skip]
    assert sorted(skipped) == sorted((a, "long_500k") for a in registry._ARCHS
                                     if registry.get_arch(a).family == "lm")


def test_knn_rows_pad_as_jax():
    from repro.configs import knn_index as jknn

    for n in (1, 255, 256, 511, 512, 1 << 24):
        assert knn_index._rows(n) == jknn._rows(n)
    assert knn_index._rows(1 << 24) == 16_777_728


# ---------------------------------------------------------------------------
# the kNN index's two steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def knn_case():
    """The smoke config's tables over a 16 x 16 road network's exact index
    (the reference construction), rows padded as the dry run pads them, and
    one level of the build's inputs drawn from a seed."""
    cfg = jknn_smoke()
    g = road_network(16, 16, seed=0)
    idx = knn_index_cons_plus(build_bngraph(g), pick_objects(g.n, 0.2, seed=0), cfg.k)
    rows = knn_index._rows(g.n)
    vk_ids = np.full((rows, cfg.k), -1, np.int32)
    vk_ids[: g.n] = idx.ids
    vk_d = np.full((rows, cfg.k), np.inf, np.float32)
    vk_d[: g.n] = idx.dists
    rng = np.random.default_rng(3)
    s, t = cfg.level_batch, cfg.tau
    level = {
        "verts": rng.permutation(g.n)[:s].astype(np.int32),
        "nbr": rng.integers(-1, g.n, (s, t)).astype(np.int32),
        "w": rng.uniform(0.5, 20.0, (s, t)).astype(np.float32),
        "extra_ids": rng.integers(-1, g.n, (s, cfg.k)).astype(np.int32),
        "extra_d": rng.uniform(0.0, 50.0, (s, cfg.k)).astype(np.float32),
    }
    return cfg, g.n, vk_ids, vk_d, level


_BUILD_ARGS = ("verts", "nbr", "w", "extra_ids", "extra_d")


def test_knn_build_matches_jax(knn_case, rules):
    cfg, _, vk_ids, vk_d, level = knn_case
    fn, *_ = jsteps.make_knn_build(cfg, rules)
    want = jax.jit(fn)(*(jnp.asarray(level[k]) for k in _BUILD_ARGS), jnp.asarray(vk_ids),
                       jnp.asarray(vk_d))
    step = steps.make_knn_build(knn_index.make_smoke(), device="cpu")
    tables = (torch.from_numpy(vk_ids.copy()), torch.from_numpy(vk_d.copy()))
    got = step(*(torch.from_numpy(level[k]) for k in _BUILD_ARGS), *tables)
    assert got[0] is tables[0] and got[1] is tables[1]  # in place
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    changed = (got[0].numpy() != vk_ids).any(1)
    assert changed.any() and set(np.flatnonzero(changed)) <= set(level["verts"].tolist())


@pytest.mark.parametrize("start", [0, 37, 10_000])
def test_knn_build_contiguous_matches_jax_and_scatter(knn_case, rules, start):
    """The contiguous form writes the level's rows as one slice (a start past
    the end clamped as ``dynamic_update_slice`` clamps it), equal to the
    scatter form on the vertices of that slice."""
    cfg, _, vk_ids, vk_d, level = knn_case
    fn, *_ = jsteps.make_knn_build(cfg, rules, contiguous=True)
    rest = [level[k] for k in _BUILD_ARGS[1:]]
    want = jax.jit(fn)(jnp.int32(start), *map(jnp.asarray, rest), jnp.asarray(vk_ids),
                       jnp.asarray(vk_d))
    contig = steps.make_knn_build(knn_index.make_smoke(), contiguous=True, device="cpu")
    got = contig(start, *map(torch.from_numpy, rest), torch.from_numpy(vk_ids.copy()),
                 torch.from_numpy(vk_d.copy()))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    s = cfg.level_batch
    first = min(start, vk_ids.shape[0] - s)
    scatter = steps.make_knn_build(knn_index.make_smoke(), device="cpu")
    verts = torch.arange(first, first + s, dtype=torch.int32)
    other = scatter(verts, *map(torch.from_numpy, rest), torch.from_numpy(vk_ids.copy()),
                    torch.from_numpy(vk_d.copy()))
    assert torch.equal(other[0], got[0]) and torch.equal(other[1], got[1])


def test_knn_serve_matches_jax(knn_case, rules):
    cfg, n, vk_ids, vk_d, _ = knn_case
    queries = np.arange(0, n, 3, dtype=np.int32)[: cfg.query_batch]
    fn, *_ = jsteps.make_knn_serve(cfg, rules)
    want = jax.jit(fn)(jnp.asarray(vk_ids), jnp.asarray(vk_d), jnp.asarray(queries))
    serve = steps.make_knn_serve(knn_index.make_smoke(), device="cpu")
    got = serve(torch.from_numpy(vk_ids), torch.from_numpy(vk_d), torch.from_numpy(queries))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), vk_ids[queries])


# ---------------------------------------------------------------------------
# xdeepfm
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def xdeepfm_model():
    from repro.configs import xdeepfm as jcfg_mod
    from repro_torch.configs import xdeepfm

    jcfg, tcfg = jcfg_mod.make_smoke(), xdeepfm.make_smoke()
    jparams = jrc.init_params(jax.random.PRNGKey(4), jcfg)
    tparams = rc.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_recsys_forward_matches_jax(xdeepfm_model, rules):
    jcfg, tcfg, jparams, tparams = xdeepfm_model
    batch = pipeline.RecsysStream(n_sparse=tcfg.n_sparse, bag=tcfg.bag_size,
                                  rows=tcfg.table_rows, batch=48).batch_at(2)
    fn, *_ = jsteps.make_recsys_forward(jcfg, rules)
    want = jax.jit(fn)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    fwd = steps.make_recsys_forward(tcfg, device="cpu")
    got = fwd(tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tuple(got.shape) == (48,)
    _close(got, want)


def test_recsys_retrieval_matches_jax(xdeepfm_model, rules):
    jcfg, tcfg, jparams, tparams = xdeepfm_model
    k, n = 10, tcfg.table_rows
    ids = pipeline.RecsysStream(n_sparse=tcfg.n_sparse, bag=tcfg.bag_size,
                                rows=tcfg.table_rows, batch=1).batch_at(5)["sparse_ids"]
    fn, *_ = jsteps.make_recsys_retrieval(jcfg, rules, n, k=k)
    want_ids, want_s = jax.jit(fn)(jparams, {"sparse_ids": jnp.asarray(ids)})
    retrieve = steps.make_recsys_retrieval(tcfg, n, k=k, device="cpu")
    got_ids, got_s = retrieve(tparams, {"sparse_ids": torch.from_numpy(ids)})
    assert tuple(got_ids.shape) == (1, k) and got_ids.dtype == torch.int32
    _close(got_s, want_s)
    s = np.asarray(want_s[0], np.float64)
    gap = np.minimum(np.abs(np.diff(s, prepend=np.inf)), np.abs(np.diff(s, append=-np.inf)))
    clear = gap > GAP
    assert clear.sum() >= k // 2
    np.testing.assert_array_equal(got_ids[0].numpy()[clear], np.asarray(want_ids[0])[clear])


# ---------------------------------------------------------------------------
# LM prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", ["qwen2.5-3b", "granite-moe-1b-a400m"])
def test_lm_prefill_then_decode_match_jax(arch_id, rules):
    jcfg = jregistry.get_arch(arch_id).make_smoke()
    tcfg = registry.get_arch(arch_id).make_smoke()
    batch, prompt, max_len, n_steps = 2, 12, 16, 3
    jparams = jtr.init_params(jax.random.PRNGKey(7), jcfg)
    tparams = tr.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, tcfg.vocab, (batch, prompt)).astype(np.int32)
    nxt = rng.integers(0, tcfg.vocab, (n_steps, batch)).astype(np.int32)

    jprefill, *_ = jsteps.make_lm_prefill(jcfg, rules, max_len)
    jdecode, *_ = jsteps.make_lm_decode(jcfg, rules, batch, max_len)
    want, jcache = jax.jit(jprefill)(jparams, jnp.asarray(tokens))
    prefill = steps.make_lm_prefill(tcfg, max_len, device="cpu")
    decode = steps.make_lm_decode(tcfg, batch, max_len, device="cpu")
    with torch.no_grad():
        got, cache = prefill(tparams, torch.from_numpy(tokens))
        _close(got, want, "prefill logits")
        _close(cache["k"], jcache["k"], "prefill cache")
        jdecode = jax.jit(jdecode)
        for i in range(n_steps):
            want, jcache = jdecode(jparams, jcache, jnp.asarray(nxt[i]))
            got, cache = decode(tparams, cache, torch.from_numpy(nxt[i]))
            _close(got, want, f"decode step {i}")
    assert cache["len"] == int(jcache["len"]) == prompt + n_steps
    _close(cache["v"], jcache["v"], "decoded cache")


def test_lm_decode_refuses_other_cache_layouts_and_shapes():
    cfg = registry.get_arch("qwen2.5-3b").make_smoke()
    with pytest.raises(ValueError, match="cache_layout='d'.*no one-card counterpart"):
        steps.make_lm_decode(cfg, 2, 16, cache_layout="d", device="cpu")
    params = tr.init_params(cfg, device="cpu")
    decode = steps.make_lm_decode(cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="the step was made for"):
        decode(params, tr.init_cache(cfg, 2, 8, device="cpu"), torch.zeros(2, dtype=torch.int32))


_FACTORIES = {
    "make_lm_prefill": lambda **kw: steps.make_lm_prefill(
        registry.get_arch("qwen2.5-3b").make_smoke(), 16, **kw),
    "make_lm_decode": lambda **kw: steps.make_lm_decode(
        registry.get_arch("qwen2.5-3b").make_smoke(), 2, 16, **kw),
    "make_recsys_forward": lambda **kw: steps.make_recsys_forward(
        registry.get_arch("xdeepfm").make_smoke(), **kw),
    "make_recsys_retrieval": lambda **kw: steps.make_recsys_retrieval(
        registry.get_arch("xdeepfm").make_smoke(), 64, k=5, **kw),
    "make_knn_build": lambda **kw: steps.make_knn_build(knn_index.make_smoke(), **kw),
    "make_knn_serve": lambda **kw: steps.make_knn_serve(knn_index.make_smoke(), **kw),
}


@pytest.mark.parametrize("name", sorted(_FACTORIES))
def test_factory_needs_a_card_unless_cpu_is_asked(name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _FACTORIES[name]()
    assert callable(_FACTORIES[name](device="cpu"))


def test_knn_step_refuses_tables_elsewhere():
    serve = steps.make_knn_serve(knn_index.make_smoke(), device="meta")
    tables = torch.zeros((8, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="the tables lie on cpu"):
        serve(tables, tables.float(), torch.zeros(2, dtype=torch.int32))
