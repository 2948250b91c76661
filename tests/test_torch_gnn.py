"""The port's GNN models and irreps algebra on the CPU, held against the JAX
package (``repro/models/gnn``): the CG tables and Wigner matrices bit for bit
(both are the same numpy float64 code), the twins of
``tests/models/test_irreps.py`` on the port, each tensor op (``sh``,
``bessel_rbf``, ``tensor_product``, ``linear_mix``, ``gate``, the scatters,
``degree``, the species gather) on seeded numpy inputs, and ``forward`` and
``loss_fn`` of gcn-cora, egnn, nequip and mace at their smoke configs on
``GraphStream(10, 24, 4)`` and at their full configs on the two field layouts
of ``test_gnn_shape_variants_forward`` (``full_graph_sm``, ``molecule``), with
JAX's parameters carried over by ``tree_from_numpy``.

Tolerance: float32, rtol = atol = 1e-5 (the two frameworks sum products and
segments in other orders, ~1e-6 at these sizes). mace is held relative to
each value's largest magnitude (its B-basis cubes unnormalised edge sums, so
its outputs reach 1e3-1e13): |port - jax| <= 1e-5 (max|jax| + |jax|).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import egnn as jegnn_cfg
from repro.configs import gcn_cora as jgcn_cfg
from repro.configs import mace as jmace_cfg
from repro.configs import nequip as jnequip_cfg
from repro.models.gnn import common as jcommon
from repro.models.gnn import egnn as jegnn
from repro.models.gnn import gcn as jgcn
from repro.models.gnn import irreps as jirreps
from repro.models.gnn import mace as jmace
from repro.models.gnn import nequip as jnequip
from repro_torch.configs import egnn as egnn_cfg
from repro_torch.configs import gcn_cora as gcn_cfg
from repro_torch.configs import mace as mace_cfg
from repro_torch.configs import nequip as nequip_cfg
from repro_torch.data import pipeline
from repro_torch.models.common import tree_from_numpy
from repro_torch.models.gnn import common, egnn, gcn, irreps, mace, nequip

TOL = 1e-5

# arch -> (JAX config module, port config module, JAX model, port model)
ARCHS = {
    "gcn-cora": (jgcn_cfg, gcn_cfg, jgcn, gcn),
    "egnn": (jegnn_cfg, egnn_cfg, jegnn, egnn),
    "nequip": (jnequip_cfg, nequip_cfg, jnequip, nequip),
    "mace": (jmace_cfg, mace_cfg, jmace, mace),
}


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops: under the parallel tier-1 run (several workers on a few
    cores) torch's intra-op thread pool makes each wait on oversubscribed
    threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, *, relative=False, err_msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    if relative:
        scale = max(float(np.abs(want).max()), 1e-30)
        got, want = got / scale, want / scale
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=err_msg)


def _t(batch: dict) -> dict:
    return {key: torch.from_numpy(np.asarray(val)) for key, val in batch.items()}


def _j(batch: dict) -> dict:
    return {key: jnp.asarray(val) for key, val in batch.items()}


def _random_rotation(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


# ---------------------------------------------------------------------------
# the numpy tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", irreps.cg_paths(2), ids=lambda p: "%d%d%d" % p)
def test_real_cg_equals_jax(path):
    got, want = irreps.real_cg(*path), jirreps.real_cg(*path)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_cg_paths_equal_jax():
    for l_max in range(4):
        assert irreps.cg_paths(l_max) == jirreps.cg_paths(l_max)
    assert len(irreps.cg_paths(2)) == 15


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("l", [0, 1, 2, 3])
def test_wigner_d_equals_jax(l, seed):
    q = _random_rotation(seed)
    np.testing.assert_array_equal(irreps.wigner_d(l, q), jirreps.wigner_d(l, q))


# ---------------------------------------------------------------------------
# twins of tests/models/test_irreps.py on the port
# ---------------------------------------------------------------------------


def test_cg_dot_and_cross():
    c110 = irreps.real_cg(1, 1, 0)[:, :, 0]
    assert np.allclose(c110, np.eye(3) * c110[0, 0], atol=1e-12)
    c111 = irreps.real_cg(1, 1, 1)
    eps = np.zeros((3, 3, 3))
    for i, j, k in [(0, 1, 2), (1, 2, 0), (2, 0, 1)]:
        eps[i, j, k] = 1
        eps[j, i, k] = -1
    assert np.allclose(np.abs(c111), np.abs(eps) * np.abs(c111).max(), atol=1e-12)


def test_cg_orthonormal_columns():
    for (l1, l2, l3) in irreps.cg_paths(2):
        c = irreps.real_cg(l1, l2, l3).reshape(-1, 2 * l3 + 1)
        g = c.T @ c
        assert np.allclose(g, np.eye(2 * l3 + 1) * g[0, 0], atol=1e-10), (l1, l2, l3)


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=0, max_value=10_000))
def test_wigner_orthogonal_and_sh_equivariant(seed):
    q = _random_rotation(seed)
    v = np.random.default_rng(seed).standard_normal((6, 3))
    sh_v = irreps.sh(torch.from_numpy(v), 2)
    sh_rv = irreps.sh(torch.from_numpy(v @ q.T), 2)
    assert sh_v[2].dtype == torch.float64
    for l in (1, 2):
        d = irreps.wigner_d(l, q)
        assert np.allclose(d @ d.T, np.eye(2 * l + 1), atol=1e-10)
        np.testing.assert_allclose(sh_rv[l].numpy(), sh_v[l].numpy() @ d.T, rtol=1e-6,
                                   atol=1e-6)


def _molecule(n, e, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "species": torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)),
        "pos": torch.from_numpy((rng.standard_normal((n, 3)) * scale).astype(np.float32)),
        "edge_index": torch.from_numpy(rng.integers(0, n, (2, e)).astype(np.int32)),
        "graph_id": torch.zeros((n,), dtype=torch.int32),
        "graph_targets": torch.zeros((1,), dtype=torch.float32),
    }


@pytest.mark.parametrize("model", ["nequip", "mace"])
def test_energy_e3_invariance(model):
    batch = _molecule(16, 40, 0, scale=1.5)
    if model == "nequip":
        cfg = nequip.NequIPConfig(name="t", n_layers=2, d_hidden=8, n_species=4)
        mod = nequip
    else:
        cfg = mace.MACEConfig(name="t", n_layers=2, d_hidden=8, n_species=4)
        mod = mace
    params = mod.init_params(cfg, seed=0, device="cpu")
    e1 = float(mod.loss_fn(params, batch, cfg))
    q = torch.from_numpy(_random_rotation(3).T.astype(np.float32))
    e2 = float(mod.loss_fn(params, dict(batch, pos=batch["pos"] @ q + 7.5), cfg))
    np.testing.assert_allclose(e1, e2, rtol=1e-4)


def test_mace_correlation_order_changes_output():
    """corr=3 must produce genuinely higher-order terms than corr=1."""
    batch = _molecule(10, 24, 1)
    c3 = mace.MACEConfig(name="t", n_layers=1, d_hidden=8, n_species=4, correlation_order=3)
    c1 = mace.MACEConfig(name="t", n_layers=1, d_hidden=8, n_species=4, correlation_order=1)
    params = mace.init_params(c3, seed=0, device="cpu")
    e3_ = float(mace.loss_fn(params, batch, c3))
    e1_ = float(mace.loss_fn(params, batch, c1))
    assert not np.isclose(e3_, e1_)


# ---------------------------------------------------------------------------
# the tensor ops against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sh_matches_jax(dtype):
    rng = np.random.default_rng(4)
    v = (rng.standard_normal((50, 3)) * 3).astype(dtype)
    v[7] = 0.0  # a zero vector: eps keeps it finite on both sides
    got = irreps.sh(torch.from_numpy(v), 2)
    with jax.enable_x64(dtype == np.float64):
        want = jirreps.sh(jnp.asarray(v), 2)
        want = {l: np.asarray(y) for l, y in want.items()}
    assert set(got) == set(want) == {0, 1, 2}
    for l in got:
        assert got[l].dtype == torch.from_numpy(v).dtype
        _close(got[l], want[l], err_msg=f"l={l}")


def test_bessel_rbf_matches_jax():
    rng = np.random.default_rng(5)
    r = np.abs(rng.standard_normal(200) * 4).astype(np.float32)
    r[:3] = [0.0, 5.0, 9.0]  # at 0, at the cutoff, past it
    _close(irreps.bessel_rbf(torch.from_numpy(r), 8, 5.0), jirreps.bessel_rbf(jnp.asarray(r), 8, 5.0))


def _irreps_feats(rng, lead, c, ls=(0, 1, 2)):
    return {l: rng.standard_normal(lead + (c, 2 * l + 1)).astype(np.float32) for l in ls}


@pytest.mark.parametrize("filter_channels", [False, True], ids=["sh_filter", "channel_filter"])
def test_tensor_product_matches_jax(filter_channels):
    rng = np.random.default_rng(6)
    e, c = 40, 6
    f1 = _irreps_feats(rng, (e,), c)
    if filter_channels:
        f2 = _irreps_feats(rng, (e,), c)
    else:
        f2 = {l: y.numpy() for l, y in irreps.sh(torch.from_numpy(
            rng.standard_normal((e, 3)).astype(np.float32)), 2).items()}
    path_w = {p: rng.standard_normal((e, c)).astype(np.float32) for p in irreps.cg_paths(2)}
    got = irreps.tensor_product(_t(f1), _t(f2), _t(path_w))
    want = jirreps.tensor_product(_j(f1), _j(f2), _j(path_w))
    assert set(got) == set(want) == {0, 1, 2}
    for l in got:
        _close(got[l], want[l], err_msg=f"l={l}")


def test_linear_mix_matches_jax():
    rng = np.random.default_rng(7)
    feats = _irreps_feats(rng, (30,), 5)
    weights = {l: rng.standard_normal((5, 5)).astype(np.float32) for l in (0, 2)}
    got = irreps.linear_mix(_t(feats), _t(weights))
    want = jirreps.linear_mix(_j(feats), _j(weights))
    assert set(got) == set(want) == {0, 2}
    for l in got:
        _close(got[l], want[l])


@pytest.mark.parametrize("scalar_layout", ["channels_x1", "channels"])
def test_gate_matches_jax(scalar_layout):
    """Both branches of the gate: scalars (n, C, 1) as the models keep them,
    and (n, C), where the gate gains an axis to meet (n, C, 2l+1)."""
    rng = np.random.default_rng(8)
    feats = _irreps_feats(rng, (20,), 4)
    if scalar_layout == "channels":
        feats[0] = feats[0][:, :, 0]
    got = irreps.gate(_t(feats))
    want = jirreps.gate(_j(feats))
    assert set(got) == set(want) == {0, 1, 2}
    for l in got:
        _close(got[l], want[l])
    alone = irreps.gate({0: torch.from_numpy(feats[0])})
    assert set(alone) == {0}


@pytest.mark.parametrize("width", [0, 1, 7])
def test_scatters_and_degree_match_jax(width):
    rng = np.random.default_rng(9 + width)
    n, e = 13, 60
    dst = rng.integers(0, n - 2, e).astype(np.int32)  # the last two nodes get nothing
    msg = rng.standard_normal((e, width) if width else (e,)).astype(np.float32)
    tm, td, jm, jd = torch.from_numpy(msg), torch.from_numpy(dst), jnp.asarray(msg), jnp.asarray(dst)
    _close(common.scatter_sum(tm, td, n), jcommon.scatter_sum(jm, jd, n))
    _close(common.degree(td, n), jcommon.degree(jd, n))
    if width:
        _close(common.scatter_mean(tm, td, n), jcommon.scatter_mean(jm, jd, n))


def test_species_gather_clamps_as_jax():
    """An out-of-range species id is clamped (JAX's gather), not refused; a
    negative one counts from the end first. torch's own indexing refuses."""
    table = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    ids = np.array([0, 3, 4, 15, -1, -4, -5, -40], dtype=np.int32)
    w = np.random.default_rng(3).standard_normal((len(ids), 3)).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_(True)
    got = common.take_rows(t, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(jnp.asarray(table)[jnp.asarray(ids)]))
    # the gradient drops the clamped reads, as XLA's scatter does
    (grad,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), t)
    jgrad = jax.grad(lambda x: (x[jnp.asarray(ids)] * w).sum())(jnp.asarray(table))
    np.testing.assert_array_equal(grad.numpy(), np.asarray(jgrad))
    with pytest.raises(IndexError):
        torch.from_numpy(table)[torch.from_numpy(ids)]


def test_species_past_n_species_match_jax_in_the_models():
    """The drivers' molecule stream draws species in [0, 16) for the smoke
    configs' 4: nequip and mace give JAX's loss on such a batch."""
    batch = pipeline.GraphStream(n_nodes=6, n_edges=12, batch=3).batch_at(0)
    assert batch["species"].max() >= 4
    for name in ("nequip", "mace"):
        jc, tc, jm, tm = ARCHS[name]
        jparams = jm.init_params(jax.random.PRNGKey(1), jc.make_smoke())
        params = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        want = jax.jit(lambda p, b: jm.loss_fn(p, b, jc.make_smoke()))(jparams, _j(batch))
        _close(tm.loss_fn(params, _t(batch), tc.make_smoke()), want, relative=True, err_msg=name)


# ---------------------------------------------------------------------------
# the four architectures against JAX
# ---------------------------------------------------------------------------


def _shape_variant_batch(cfg, shape):
    """``test_gnn_shape_variants_forward``'s reduced batch of ``shape``'s field
    layout (24 nodes, 60 edges)."""
    rng = np.random.default_rng(0)
    n, e = 24, 60
    batch = {
        "edge_index": rng.integers(0, n, (2, e)).astype(np.int32),
        "pos": rng.standard_normal((n, 3)).astype(np.float32),
    }
    if getattr(cfg, "d_feat", 0) > 0:
        batch["node_feat"] = rng.standard_normal((n, cfg.d_feat)).astype(np.float32)
    else:
        batch["species"] = rng.integers(0, 4, n).astype(np.int32)
    if getattr(cfg, "task", "node_class") == "energy":
        batch["graph_id"] = np.zeros((n,), np.int32)
        batch["graph_targets"] = np.zeros((1,), np.float32)
    else:
        ncls = getattr(cfg, "n_classes", getattr(cfg, "n_out", 2))
        batch["labels"] = rng.integers(0, ncls, n).astype(np.int32)
    assert shape in ("full_graph_sm", "molecule")
    return batch


def _forward_and_loss_match(name, jcfg, tcfg, batch):
    _, _, jm, tm = ARCHS[name]
    relative = name == "mace"
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    params = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    # one compile of JAX's forward and loss (op by op, JAX compiles each op)
    want, want_loss = jax.jit(lambda p, b: (jm.forward(p, b, jcfg), jm.loss_fn(p, b, jcfg)))(
        jparams, _j(batch))
    got = tm.forward(params, _t(batch), tcfg)
    got, want = (got, want) if name == "egnn" else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert bool(torch.isfinite(g).all())
        _close(g, w, relative=relative, err_msg=name)
    loss = tm.loss_fn(params, _t(batch), tcfg)
    assert loss.shape == () and bool(torch.isfinite(loss))
    _close(loss, want_loss, relative=relative, err_msg=name)


@pytest.mark.parametrize("name", list(ARCHS))
def test_smoke_forward_and_loss_match_jax(name):
    jc, tc, _, _ = ARCHS[name]
    jcfg, tcfg = jc.make_smoke(), tc.make_smoke()
    batch = pipeline.GraphStream(10, 24, 4, d_feat=tcfg.d_feat).batch_at(0)
    _forward_and_loss_match(name, jcfg, tcfg, batch)


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_shape_variants_forward_and_loss_match_jax(name, shape):
    """The full configs of each shape (published widths) on the reduced batch
    of ``test_gnn_shape_variants_forward``."""
    jc, tc, _, _ = ARCHS[name]
    jcfg, tcfg = jc.make_config(shape), tc.make_config(shape)
    _forward_and_loss_match(name, jcfg, tcfg, _shape_variant_batch(tcfg, shape))


@pytest.mark.parametrize("name", list(ARCHS))
def test_init_params_has_jax_tree(name):
    """The port's seeded ``init_params`` draws the JAX package's tree: the same
    key paths, shapes and dtypes at the smoke and the full config."""
    jc, tc, jm, tm = ARCHS[name]
    for jcfg, tcfg in ((jc.make_smoke(), tc.make_smoke()), (jc.make_config(), tc.make_config())):
        want = {jax.tree_util.keystr(p): (leaf.shape, str(leaf.dtype)) for p, leaf in
                jax.tree_util.tree_flatten_with_path(jax.eval_shape(
                    lambda k: jm.init_params(k, jcfg), jax.random.PRNGKey(0)))[0]}
        ours = tm.init_params(tcfg, seed=0, device="cpu")
        jtree = jax.tree.map(lambda t: np.zeros(t.shape, str(t.dtype).split(".")[-1]), ours)
        got = {jax.tree_util.keystr(p): (leaf.shape, str(leaf.dtype)) for p, leaf in
               jax.tree_util.tree_flatten_with_path(jtree)[0]}
        assert got == want
        again = tm.init_params(tcfg, seed=0, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(again)))


def test_egnn_coordinates_move_equivariantly():
    """egnn's second output, the moved coordinates, rotate with the input."""
    cfg = egnn.EGNNConfig(name="t", n_layers=2, d_hidden=8, d_feat=0, n_species=4)
    params = egnn.init_params(cfg, seed=0, device="cpu")
    batch = _molecule(12, 30, 2)
    batch["edge_index"] = batch["edge_index"][:, batch["edge_index"][0] != batch["edge_index"][1]]
    q = torch.from_numpy(_random_rotation(5).T.astype(np.float32))
    out1, x1 = egnn.forward(params, batch, cfg)
    out2, x2 = egnn.forward(params, dict(batch, pos=batch["pos"] @ q + 2.0), cfg)
    np.testing.assert_allclose(out2.detach().numpy(), out1.detach().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(x2.detach().numpy(), (x1 @ q + 2.0).detach().numpy(), rtol=1e-4,
                               atol=1e-4)


def test_configs_are_frozen_dataclasses_with_torch_dtype():
    for _, tc, _, _ in ARCHS.values():
        cfg = tc.make_smoke()
        assert cfg.param_dtype == torch.float32
        with pytest.raises(dataclasses.FrozenInstanceError):
            cfg.name = "x"
