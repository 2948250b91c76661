"""The port's GNN training path on the CPU, held against the JAX package: one
``make_gnn_train`` step of each architecture's smoke config against JAX's
``make_gnn_train`` step jitted on the host mesh (loss, grad_norm, every
gradient, parameter and moment leaf); egnn's non-finite gradients at a
zero-length edge, on both sides alike; ``GraphStream`` / ``FullGraphStream``;
``sample_khop`` / ``pad_subgraph``; the sampled-training pipeline of
``tests/graph/test_minibatch_integration.py``; the registry and the configs at
every shape; ``launch.train --arch <gnn> --smoke``; and nequip's ``(params,
opt_state)`` checkpoint across both packages.

Tolerance: float32, rtol = atol = 1e-5. Gradients and moments are held
relative to each leaf's largest magnitude, |port - jax| <= 1e-5 (scale +
|jax|) with scale the larger of the leaf's max |jax| and 1e-6 of the tree's
(for mace its parameters too: its B-basis cubes unnormalised edge sums). The
floor is for leaves whose exact gradient is zero: mace's order-2 weights of
the antisymmetric paths (1,1,1), (2,2,1), (1,2,2), (2,1,2) multiply A x A,
whose exact value there vanishes (a channel's vector crossed with itself),
so both sides hold rounding, ~1e-10 beside gradients of ~1e2. Trained
parameters are compared where JAX's gradient exceeds 1e-6 of the tree's
largest: AdamW's first step moves an entry by about lr * sign(g), and where
g is rounding so is its sign. Streams, the sampler, configs and checkpoints
are held exactly.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import common as jcommon_cfg
from repro.configs import registry as jregistry
from repro.data import pipeline as jpipe
from repro.distributed.sharding import make_rules
from repro.graph import generators as jgen
from repro.graph import sampler as jsampler
from repro.launch.mesh import make_host_mesh
from repro.models.gnn import egnn as jegnn
from repro.models.gnn import gcn as jgcn
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import common as common_cfg
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.graph import generators, sampler
from repro_torch.launch import train as train_cli
from repro_torch.models.common import tree_from_numpy
from repro_torch.models.gnn import egnn, gcn
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.tree import leaves, leaves_with_paths, tree_map

TOL = 1e-5
MOVED = 1e-6
GNN = ("gcn-cora", "egnn", "nequip", "mace")


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops: under the parallel tier-1 run torch's intra-op thread
    pool makes each wait on oversubscribed threads; one thread also makes a
    run's sums the same from run to run (the resume test's losses)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _flat(tree) -> dict:
    """numpy leaves of a JAX / numpy / torch tree by their key path."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return {path: leaf.detach().numpy() for path, leaf in leaves_with_paths(tree)}
    return {tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _largest(a) -> float:
    """The largest finite |a| (0 for none)."""
    a = np.asarray(a)
    return float(np.abs(np.where(np.isfinite(a), a, 0)).max(initial=0))


def _by_max(got, want, floor=0.0, err_msg=""):
    """|got - want| <= TOL (scale + |want|), scale = max(max|want|, floor);
    non-finite where want is."""
    scale = max(_largest(want), floor, 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=TOL, atol=TOL, err_msg=err_msg)


def _held_tree(got: dict, want: dict, what: str) -> None:
    """Every leaf by ``_by_max`` with the floor 1e-6 of the tree's largest."""
    assert got.keys() == want.keys()
    floor = MOVED * max(_largest(w) for w in want.values())
    for key, w in want.items():
        _by_max(got[key], w, floor, err_msg=f"{what} {key}")


def _t(batch):
    return {key: torch.from_numpy(np.asarray(val)) for key, val in batch.items()}


def _j(batch):
    return {key: jnp.asarray(val) for key, val in batch.items()}


def _jax_step(name, jcfg, jparams, jbatch):
    """JAX's ``make_gnn_train`` step, jitted on the host mesh, and its grads."""
    rules = make_rules(make_host_mesh())
    fn, *_ = jsteps.make_gnn_train(name, jcfg, rules, jbatch, jadamw.AdamWConfig())
    mod = jsteps.GNN_MODULES[name]
    jg = jax.jit(jax.grad(lambda p, b: mod.loss_fn(p, b, jcfg)))(jparams, jbatch)
    return jax.jit(fn)(jparams, jadamw.init(jparams), jbatch), jg


@pytest.mark.parametrize("name", GNN)
def test_gnn_train_step_matches_jax(name):
    """The driver's smoke batch (``GraphStream(12, 32, 8)``; nequip's and
    mace's species run past their 4, clamped on both sides)."""
    arch = registry.get_arch(name)
    jarch = jregistry.get_arch(name)
    jcfg, cfg = jarch.make_smoke(), arch.make_smoke()
    batch = train_cli.make_stream(arch, cfg, smoke=True).batch_at(0)
    mod = steps.GNN_MODULES[name]
    jparams = jsteps.GNN_MODULES[name].init_params(jax.random.PRNGKey(0), jcfg)
    (jnew, jstate, jmetrics), jg = _jax_step(name, jcfg, jparams, _j(batch))

    params = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    grads = torch.autograd.grad(mod.loss_fn(params, _t(batch), cfg), flat, allow_unused=True,
                                materialize_grads=True)
    for p in flat:
        p.requires_grad_(False)
    it = iter(grads)
    gtree = tree_map(lambda _: next(it), params)
    want_g = _flat(jg)
    _held_tree(_flat(gtree), want_g, "grad")

    state = adamw.init(params)
    params, state, metrics = steps.make_gnn_train(name, cfg, adamw.AdamWConfig(),
                                                  device="cpu")(params, state, _t(batch))
    loss_tol = dict(rtol=TOL, atol=0)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), **loss_tol)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               **loss_tol)
    assert int(state["count"]) == int(jstate["count"]) == 1
    _held_tree(_flat(state["m"]), _flat(jstate["m"]), "m")
    _held_tree(_flat(state["v"]), _flat(jstate["v"]), "v")
    got, want = _flat(params), _flat(jnew)
    g_floor = MOVED * max(_largest(g) for g in want_g.values())
    for key in want:
        moved = np.abs(want_g[key]) > g_floor
        if name == "mace":
            _by_max(got[key][moved], want[key][moved], err_msg=f"param {key}")
        else:
            np.testing.assert_allclose(got[key][moved], want[key][moved], rtol=TOL, atol=TOL,
                                       err_msg=f"param {key}")


def test_egnn_nonfinite_gradients_at_a_self_loop_match_jax():
    """A reference defect the port reproduces: at a zero-length edge the
    derivative of ``sqrt(d2)`` is infinite, so from the second layer on (where
    the coordinates depend on the parameters) a three-layer egnn's gradients
    are not all finite. The loss is finite and equal; the same entries of the
    same leaves are non-finite on both sides, and the finite ones agree."""
    jcfg = jegnn.EGNNConfig(name="t", n_layers=3, d_hidden=8, d_feat=4)
    cfg = egnn.EGNNConfig(name="t", n_layers=3, d_hidden=8, d_feat=4)
    batch = pipeline.GraphStream(n_nodes=6, n_edges=12, batch=2, d_feat=4).batch_at(1)
    batch["edge_index"][:, 0] = 3  # node 3 -> node 3
    jparams = jegnn.init_params(jax.random.PRNGKey(0), jcfg)
    jloss, jg = jax.value_and_grad(lambda p: jegnn.loss_fn(p, _j(batch), jcfg))(jparams)
    params = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = egnn.loss_fn(params, _t(batch), cfg)
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    assert np.isfinite(float(loss.detach())) and np.isfinite(float(jloss))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    it = iter(grads)
    got, want = _flat(tree_map(lambda _: next(it), params)), _flat(jg)
    bad = {key for key, g in want.items() if not np.isfinite(g).all()}
    print(f"non-finite leaves: port {sum(not np.isfinite(g).all() for g in got.values())}, "
          f"jax {len(bad)} of {len(want)}")
    assert bad, "the self loop should make some gradients non-finite"
    for key, w in want.items():
        np.testing.assert_array_equal(np.isfinite(got[key]), np.isfinite(w), err_msg=str(key))
        fin = np.isfinite(w)
        _by_max(got[key][fin], w[fin], err_msg=str(key))
    # a train step's grad_norm is then NaN on both sides
    _, _, metrics = steps.make_gnn_train("egnn", cfg, device="cpu")(
        params, adamw.init(params), _t(batch))
    assert not np.isfinite(float(metrics["grad_norm"]))


# ---------------------------------------------------------------------------
# streams and the sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,e,b,d_feat,n_species,seed,step", [
    (12, 32, 8, 0, 16, 0, 0), (12, 32, 8, 12, 16, 0, 3), (30, 64, 4, 0, 4, 2, 1),
    (10, 24, 4, 8, 16, 1, 7)])
def test_graph_stream_matches_jax(n, e, b, d_feat, n_species, seed, step):
    ours = pipeline.GraphStream(n, e, b, n_species=n_species, d_feat=d_feat,
                                seed=seed).batch_at(step)
    theirs = jpipe.GraphStream(n, e, b, n_species=n_species, d_feat=d_feat,
                               seed=seed).batch_at(step)
    assert ours.keys() == theirs.keys()
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


@pytest.mark.parametrize("n,e,d,c,seed", [(2708, 10556, 33, 7, 0), (500, 1001, 5, 3, 4)])
def test_full_graph_stream_matches_jax(n, e, d, c, seed):
    ours = pipeline.FullGraphStream(n, e, d, c, seed=seed)
    theirs = jpipe.FullGraphStream(n, e, d, c, seed=seed).batch_at(0)
    for step in (0, 5):
        got = ours.batch_at(step)
        assert got.keys() == theirs.keys()
        for key in theirs:
            assert got[key].dtype == theirs[key].dtype, key
            np.testing.assert_array_equal(got[key], theirs[key], err_msg=key)


def _same_sub(ours, theirs):
    for field in ("nodes", "edge_index", "seeds_local"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("seeds,fanouts,seed", [
    ([0, 7, 30], (4, 3), 0), ([5, 5, 100, 224], (2, 2, 2), 3), ([17], (15, 10), 1),
    (list(range(0, 225, 9)), (3,), 2)])
def test_sample_khop_and_pad_match_jax(seeds, fanouts, seed):
    g, jg = generators.road_network(15, 15, seed=1), jgen.road_network(15, 15, seed=1)
    for field in ("indptr", "indices", "weights"):
        np.testing.assert_array_equal(getattr(g, field), getattr(jg, field))
    seeds = np.asarray(seeds, dtype=np.int64)
    sub = sampler.sample_khop(g, seeds, fanouts, seed=seed)
    jsub = jsampler.sample_khop(jg, seeds, fanouts, seed=seed)
    _same_sub(sub, jsub)
    _same_sub(sampler.pad_subgraph(sub, 256, 1024), jsampler.pad_subgraph(jsub, 256, 1024))


def test_sampler_fanout_bounds():
    """The twin of ``tests/graph/test_graph.py::test_sampler_fanout_bounds``."""
    g = generators.road_network(15, 15, seed=1)
    seeds = np.asarray([0, 7, 30], dtype=np.int64)
    sub = sampler.sample_khop(g, seeds, (4, 3), seed=0)
    # every seed present, edges reference valid local ids
    assert len(sub.seeds_local) == 3
    assert sub.edge_index.max() < len(sub.nodes)
    # fanout bound: layer1 <= 3*4 edges, layer2 <= (3*4)*3
    assert sub.edge_index.shape[1] <= 3 * 4 + 3 * 4 * 3
    padded = sampler.pad_subgraph(sub, 256, 512)
    assert padded.edge_index.shape == (2, 512) and len(padded.nodes) == 256
    assert (padded.edge_index[:, sub.edge_index.shape[1]:] == 255).all()
    with pytest.raises(ValueError):
        sampler.pad_subgraph(sub, 4, 512)


def test_sampled_training_pipeline_matches_jax():
    """The twin of ``tests/graph/test_minibatch_integration.py``: real sampler
    -> padded subgraph -> GNN train step, 3 steps from JAX's parameters, each
    side on its own sampler; the losses equal JAX's."""
    g = generators.road_network(20, 20, seed=0)  # stand-in for the 233k-node graph
    jg = jgen.road_network(20, 20, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((g.n, 32)).astype(np.float32)
    labels = rng.integers(0, 5, g.n).astype(np.int32)

    jcfg = jgcn.GCNConfig(name="mb", n_layers=2, d_hidden=8, d_feat=32, n_classes=5)
    cfg = gcn.GCNConfig(name="mb", n_layers=2, d_hidden=8, d_feat=32, n_classes=5)
    jparams = jgcn.init_params(jax.random.PRNGKey(0), jcfg)
    params = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jopt, opt = jadamw.init(jparams), adamw.init(params)
    rules = make_rules(make_host_mesh())
    step_fn = steps.make_gnn_train("gcn-cora", cfg, adamw.AdamWConfig(total_steps=10),
                                   device="cpu")

    n_pad, e_pad = 256, 1024
    losses, jlosses, jfn = [], [], None
    for step in range(3):
        seeds = rng.choice(g.n, size=16, replace=False)
        sub = sampler.pad_subgraph(sampler.sample_khop(g, seeds, (4, 3), seed=step), n_pad, e_pad)
        jsub = jsampler.pad_subgraph(jsampler.sample_khop(jg, seeds, (4, 3), seed=step), n_pad,
                                     e_pad)
        _same_sub(sub, jsub)
        batch = {"node_feat": feats[sub.nodes], "edge_index": sub.edge_index,
                 "labels": labels[sub.nodes]}
        jbatch = _j({"node_feat": feats[jsub.nodes], "edge_index": jsub.edge_index,
                     "labels": labels[jsub.nodes]})
        if jfn is None:
            jfn, *_ = jsteps.make_gnn_train("gcn-cora", jcfg, rules, jbatch,
                                            jadamw.AdamWConfig(total_steps=10))
            jfn = jax.jit(jfn)
        jparams, jopt, jm = jfn(jparams, jopt, jbatch)
        params, opt, m = step_fn(params, opt, _t(batch))
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)


# ---------------------------------------------------------------------------
# registry, configs, shapes
# ---------------------------------------------------------------------------


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("param_dtype")
    return d


@pytest.mark.parametrize("name", GNN)
def test_registry_configs_match_jax(name):
    arch, jarch = registry.get_arch(name), jregistry.get_arch(name)
    assert arch.family == jarch.family == "gnn"
    assert _fields(arch.make_smoke()) == _fields(jarch.make_smoke())
    assert arch.make_smoke().param_dtype == torch.float32
    for shape in jcommon_cfg.GNN_SHAPE_META:
        ours, theirs = arch.make_config(shape), jarch.make_config(shape)
        assert type(ours).__name__ == type(theirs).__name__
        assert _fields(ours) == _fields(theirs), shape
        assert ours.param_dtype == torch.float32 and theirs.param_dtype == jnp.float32
    assert _fields(arch.make_config()) == _fields(jarch.make_config())


def test_registry_holds_every_jax_arch():
    assert sorted(registry._ARCHS) == sorted(jregistry._ARCHS)
    for arch in registry._ARCHS.values():
        assert arch.family == jregistry.get_arch(arch.arch_id).family


def test_gnn_shapes_match_jax():
    assert common_cfg.GNN_SHAPE_META == jcommon_cfg.GNN_SHAPE_META
    ours, theirs = common_cfg.gnn_shapes(), jcommon_cfg.gnn_shapes()
    assert ours.keys() == theirs.keys()
    for shape, cell in theirs.items():
        assert cell.kind == "train" and cell.skip is None
        want = {key: (tuple(s.shape), str(s.dtype)) for key, s in cell.specs(None).items()}
        got = {key: (dims, str(dt).removeprefix("torch."))
               for key, (dims, dt) in ours[shape].specs().items()}
        assert got == want, shape
    assert common_cfg.pad512(169_984) == 169_984 and common_cfg.pad512(2_449_029) == 2_449_408


# ---------------------------------------------------------------------------
# the training driver and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", GNN)
def test_train_driver_gnn_smoke(name, capsys):
    losses = train_cli.main(["--arch", name, "--smoke", "--steps", "3", "--device", "cpu",
                             "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses)), losses
    assert "final loss" in out and out.count("step ") == 3


def test_train_driver_mace_resumes(tmp_path, capsys):
    """mace: 6 steps with checkpoints every 3, then 8 resumed from step 6,
    whose losses equal those of one uninterrupted 8-step run."""
    def run(n, extra=()):
        return train_cli.main(["--arch", "mace", "--smoke", "--steps", str(n), "--device", "cpu",
                               *extra])

    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "3"]
    first = run(6, ck)
    resumed = run(8, ck)
    assert "resumed from step 6" in capsys.readouterr().out
    assert len(first) == 6 and len(resumed) == 2
    straight = run(8)
    assert first == straight[:6] and resumed == straight[6:]


def test_gnn_entry_points_refuse_without_a_card():
    cfg = registry.get_arch("nequip").make_smoke()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.GNN_MODULES["nequip"].init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.make_gnn_train("nequip", cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "nequip", "--smoke", "--steps", "1"])
    step = steps.make_gnn_train("gcn-cora", registry.get_arch("gcn-cora").make_smoke(),
                                device="meta")
    with pytest.raises(ValueError, match="the batch's edges"):
        step({}, {}, {"edge_index": torch.zeros((2, 1), dtype=torch.int32)})


def _nequip_trees():
    """nequip's smoke (params, opt_state), count 5 and m + 0.25, on both sides
    from the same numpy parameters."""
    jcfg = jregistry.get_arch("nequip").make_smoke()
    jparams = jsteps.GNN_MODULES["nequip"].init_params(jax.random.PRNGKey(0), jcfg)
    jstate = jadamw.init(jparams)
    jstate = {**jstate, "count": jnp.asarray(5, jnp.int32),
              "m": jax.tree.map(lambda x: x + 0.25, jstate["m"])}
    params = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    state = adamw.init(params)
    state["count"] = torch.tensor(5, dtype=torch.int32)
    for m in leaves(state["m"]):
        m += 0.25
    return (jparams, jstate), (params, state)


def _same(ours, theirs):
    got, want = _flat(ours), _flat(theirs)
    assert got.keys() == want.keys()
    assert (0, "layers", 0, "lin_msg", "2") in got
    for key, leaf in want.items():
        assert got[key].dtype == leaf.dtype, key
        np.testing.assert_array_equal(got[key], leaf, err_msg=str(key))


def test_jax_nequip_checkpoint_restores_in_the_port(tmp_path):
    theirs, ours = _nequip_trees()
    jckpt.save(tmp_path, 7, theirs)
    restored, step = ckpt.restore(tmp_path, tree_map(torch.zeros_like, ours))
    assert step == 7
    _same(restored, theirs)


def test_port_nequip_checkpoint_restores_in_jax(tmp_path):
    theirs, ours = _nequip_trees()
    ckpt.save(tmp_path, 7, ours)
    restored, step = jckpt.restore(tmp_path, jax.tree.map(jnp.zeros_like, theirs))
    assert step == 7
    _same(ours, restored)
    jckpt.save(tmp_path / "jax", 7, theirs)
    mine = json.load(open(tmp_path / "step_00000007" / "manifest.json"))
    jaxs = json.load(open(tmp_path / "jax" / "step_00000007" / "manifest.json"))
    assert mine["leaves"] == jaxs["leaves"]
