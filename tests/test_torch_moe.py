"""The port's MoE layers and its four newer LM configurations on the CPU, held
against the JAX package (``rules=None`` on the JAX side): ``_moe_ffn`` at
``granite-moe-smoke`` (4 experts, top-2) and ``llama4-scout-smoke`` (4
experts, top-1), with and without assignments dropped past capacity, the
router's tie-breaking, the invariants of ``tests/models/test_transformer.py``
(a zero input gives zero, one expert is the dense FFN); then, for each of
granite-moe, llama4-scout, internlm2 and qwen1.5-110b at smoke size,
``forward``, prefill with teacher-forced decode, ``loss_fn`` and one train
step (autograd + ``adamw.update`` against ``value_and_grad`` +
``adamw.update``); parameter counts at the full configurations; the stacked
tree and checkpoints of a MoE model across both packages; and the serving
and training entry points with ``--arch granite-moe-1b-a400m``.

Inputs are made with numpy from a seed, parameters by the JAX package's
``init_params`` and carried across by ``params_from_numpy``. Tolerance:
float32, rtol = atol = 1e-5 for every compared value (the two frameworks sum
products and reductions in other orders, ~1e-6 at these sizes; routing is
compared exactly). Trained parameters are compared where JAX's gradient
exceeds 1e-6: AdamW's first step moves an entry by about lr * sign(g), and
where g is near 0 the sign is rounding.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import granite_moe_1b_a400m as jgranite
from repro.configs import internlm2_20b as jinternlm2
from repro.configs import llama4_scout_17b_a16e as jllama4
from repro.configs import qwen1_5_110b as jqwen15
from repro.configs import qwen2_5_3b as jqwen25
from repro.data import pipeline as jpipe
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import (
    granite_moe_1b_a400m,
    internlm2_20b,
    llama4_scout_17b_a16e,
    qwen1_5_110b,
    qwen2_5_3b,
)
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.tree import leaves, leaves_with_paths, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
TOL = 1e-5
MOVED = 1e-6

MOE = {"granite-moe": (jgranite, granite_moe_1b_a400m),
       "llama4-scout": (jllama4, llama4_scout_17b_a16e)}
NEW = {**MOE, "internlm2": (jinternlm2, internlm2_20b), "qwen1.5-110b": (jqwen15, qwen1_5_110b)}
ALL = {**NEW, "qwen2.5-3b": (jqwen25, qwen2_5_3b)}


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=err_msg)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> dict:
    """numpy leaves of a (numpy or JAX) tree by their key path."""
    return {tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _models(name, seed=0, **over):
    """(jcfg, tcfg, jparams, tparams): a smoke config on both sides (fields in
    ``over`` replaced on both), parameters from JAX's ``init_params``."""
    jm, tm = ALL[name]
    jcfg = dataclasses.replace(jm.make_smoke(), **over)
    tcfg = dataclasses.replace(tm.make_smoke(), **over)
    jparams = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, tr.params_from_numpy(_np_tree(jparams), tcfg, device="cpu")


def _layer0(jparams, tparams):
    return jax.tree.map(lambda a: a[0], jparams["layers"]), tparams["layers"][0]


def _tokens(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _dropped(eidx: torch.Tensor, n_tok: int, cfg) -> int:
    """Assignments past their expert's capacity."""
    cap = int(np.ceil(n_tok * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor))
    counts = np.bincount(eidx.reshape(-1).numpy(), minlength=cfg.n_experts)
    return int(np.maximum(counts - cap, 0).sum())


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5"])
@pytest.mark.parametrize("n_tok", [2, 4, 64, 96])
@pytest.mark.parametrize("name", list(MOE))
def test_moe_ffn_matches_jax(name, n_tok, cf):
    """The layer's output and its routing, at the configuration's capacity
    factor and at half of it (where experts overflow)."""
    jcfg, tcfg, jparams, tparams = _models(name, capacity_factor=cf)
    jlp, tlp = _layer0(jparams, tparams)
    x = _tokens(n_tok, tcfg.d_model, n_tok)
    got = tr._moe_ffn(tlp, torch.from_numpy(x), tcfg)
    want = jtr._moe_ffn(jlp, jnp.asarray(x), jcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    _close(got, want)
    gates, eidx = tr._moe_route(tlp, torch.from_numpy(x), tcfg)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jlp["router"]["w"], axis=-1)
    jg, je = jax.lax.top_k(jprobs, jcfg.moe_top_k)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(je))
    _close(gates, jg / jnp.maximum(jg.sum(-1, keepdims=True), 1e-9))
    if cf == 0.5 and n_tok >= 64:
        assert _dropped(eidx, n_tok, tcfg) > 0


@pytest.mark.parametrize("name", list(MOE))
def test_moe_ffn_all_tokens_to_one_expert_matches_jax(name):
    """A router that sends every token to expert 0 first: all but ``cap`` of
    its assignments go to the pad slot, on both sides alike."""
    jcfg, tcfg, jparams, tparams = _models(name)
    jlp, tlp = _layer0(jparams, tparams)
    x = np.abs(_tokens(64, tcfg.d_model, 5))
    w = np.asarray(jlp["router"]["w"]).copy()
    w[:, 0] = 1.0
    jlp = {**jlp, "router": {"w": jnp.asarray(w)}}
    tlp = {**tlp, "router": {"w": torch.from_numpy(w)}}
    _, eidx = tr._moe_route(tlp, torch.from_numpy(x), tcfg)
    cap = int(np.ceil(64 * tcfg.moe_top_k / tcfg.n_experts * tcfg.capacity_factor))
    assert bool((eidx[:, 0] == 0).all()) and _dropped(eidx, 64, tcfg) >= 64 - cap
    _close(tr._moe_ffn(tlp, torch.from_numpy(x), tcfg), jtr._moe_ffn(jlp, jnp.asarray(x), jcfg))


# columns of the router made equal, so that probabilities tie exactly
TIES = {"pairs": [(1, 0), (3, 2)], "three": [(1, 0), (2, 0)], "all": [(1, 0), (2, 0), (3, 0)]}


@pytest.mark.parametrize("ties", list(TIES))
@pytest.mark.parametrize("name", list(MOE))
def test_moe_route_ties_choose_lax_top_k_experts(name, ties):
    """Tied probabilities choose the experts ``lax.top_k`` chooses (the lower
    index first), and the layer's output follows."""
    jcfg, tcfg, jparams, tparams = _models(name)
    jlp, tlp = _layer0(jparams, tparams)
    w = np.asarray(jlp["router"]["w"]).copy()
    for dst, src in TIES[ties]:
        w[:, dst] = w[:, src]
    jlp = {**jlp, "router": {"w": jnp.asarray(w)}}
    tlp = {**tlp, "router": {"w": torch.from_numpy(w)}}
    x = _tokens(32, tcfg.d_model, 9)
    _, eidx = tr._moe_route(tlp, torch.from_numpy(x), tcfg)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jlp["router"]["w"], axis=-1)
    probs = np.asarray(jprobs)
    assert all((probs[:, dst] == probs[:, src]).all() for dst, src in TIES[ties])
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(jax.lax.top_k(jprobs, jcfg.moe_top_k)[1]))
    _close(tr._moe_ffn(tlp, torch.from_numpy(x), tcfg), jtr._moe_ffn(jlp, jnp.asarray(x), jcfg))


def _tiny_moe(**over):
    """The configuration of the JAX package's MoE tests
    (``tests/models/test_transformer.py``)."""
    fields = {**dict(name="m", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_head=8,
                     d_ff=32, vocab=32, n_experts=4, moe_top_k=2), **over}
    jcfg = jtr.TransformerConfig(**fields, param_dtype=jnp.float32)
    tcfg = tr.TransformerConfig(**fields, param_dtype=torch.float32)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tr.params_from_numpy(_np_tree(jparams), tcfg, device="cpu")
    return jcfg, tcfg, *_layer0(jparams, tparams)


def test_moe_zero_input_gives_zero_output():
    """``test_moe_routing_capacity_and_gates``: finite output of the input's
    shape, and zero tokens give zero (no bias in the experts)."""
    jcfg, tcfg, jlp, tlp = _tiny_moe()
    x = np.array(jax.random.normal(jax.random.PRNGKey(2), (64, 16)))
    y = tr._moe_ffn(tlp, torch.from_numpy(x), tcfg)
    assert tuple(y.shape) == x.shape and bool(torch.isfinite(y).all())
    _close(y, jtr._moe_ffn(jlp, jnp.asarray(x), jcfg))
    y0 = tr._moe_ffn(tlp, torch.zeros((64, 16)), tcfg)
    np.testing.assert_allclose(y0.numpy(), 0.0, atol=1e-6)


def test_moe_single_expert_equals_dense_ffn():
    """``test_moe_matches_dense_route_when_single_expert``: one expert, top-1,
    capacity factor 1 is the dense FFN with that expert's weights."""
    jcfg, tcfg, jlp, tlp = _tiny_moe(name="m1", n_experts=1, moe_top_k=1, capacity_factor=1.0)
    x = np.array(jax.random.normal(jax.random.PRNGKey(3), (32, 16)))
    y_moe = tr._moe_ffn(tlp, torch.from_numpy(x), tcfg)
    dense = {name: {"w": tlp[name][0]} for name in ("w_gate", "w_up", "w_down")}
    _close(y_moe, tr._dense_ffn(dense, torch.from_numpy(x)))
    _close(y_moe, jtr._moe_ffn(jlp, jnp.asarray(x), jcfg))


def test_moe_ffn_repeats_bit_for_bit():
    """Two calls on the same input give the same bits (the combine sums in a
    fixed order; on the card ``chip_smoke.py`` holds the same)."""
    _, tcfg, _, tparams = _models("granite-moe")
    x = torch.from_numpy(_tokens(96, tcfg.d_model, 1))
    a = tr._moe_ffn(tparams["layers"][1], x, tcfg)
    b = tr._moe_ffn(tparams["layers"][1], x, tcfg)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the four newer configurations end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(NEW))
def test_forward_matches_jax(name):
    jcfg, tcfg, jparams, tparams = _models(name)
    toks = jpipe.LMStream(vocab=tcfg.vocab, batch=2, seq=24).batch_at(0)["tokens"]
    got = tr.forward(tparams, toks, tcfg, device="cpu")
    _close(got, jtr.forward(jparams, jnp.asarray(toks), jcfg))


@pytest.mark.parametrize("name", list(NEW))
def test_prefill_and_decode_match_jax(name):
    """Prefill logits and cache, then 8 teacher-forced decode steps (at
    decode a batch of 3 tokens overflows an expert's capacity whenever two
    pick it first)."""
    jcfg, tcfg, jparams, tparams = _models(name, seed=1)
    prompt, batch = 13, 3
    toks = jpipe.LMStream(vocab=tcfg.vocab, batch=batch, seq=prompt + 8, seed=2).batch_at(0)[
        "tokens"]
    max_len = prompt + 8
    jl, jcache = jtr.prefill(jparams, jnp.asarray(toks[:, :prompt]), jcfg, max_len)
    tl, tcache = tr.prefill(tparams, toks[:, :prompt], tcfg, max_len, device="cpu")
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], key)
    for i in range(prompt, prompt + 8):
        jl, jcache = jtr.decode_step(jparams, jcache, jnp.asarray(toks[:, i]), jcfg)
        tl, tcache = tr.decode_step(tparams, tcache, torch.from_numpy(toks[:, i]), tcfg)
        _close(tl, jl, f"decode step {i}")
    assert tcache["len"] == int(jcache["len"]) == prompt + 8
    _close(tcache["v"], jcache["v"])


@pytest.mark.parametrize("name", list(NEW))
def test_loss_and_train_step_match_jax(name):
    """``loss_fn``, its gradients, and one ``make_lm_train`` step (loss,
    grad_norm, parameters and first moments) against JAX's
    ``value_and_grad`` + ``adamw.update``."""
    jcfg, tcfg, jparams, tparams = _models(name)
    batch = jpipe.LMStream(vocab=jcfg.vocab, batch=4, seq=32).batch_at(3)
    jbatch = jax.tree.map(jnp.asarray, batch)
    tbatch = {key: torch.from_numpy(val) for key, val in batch.items()}
    jloss, jg = jax.value_and_grad(lambda p, b: jtr.loss_fn(p, b, jcfg))(jparams, jbatch)
    jnew, jstate, jgn = jadamw.update(jg, jadamw.init(jparams), jparams, jadamw.AdamWConfig())

    flat = leaves(tparams)
    for p in flat:
        p.requires_grad_(True)
    loss = tr.loss_fn(tparams, tbatch, tcfg, device="cpu")
    grads = iter(torch.autograd.grad(loss, flat))
    _close(float(loss.detach()), float(jloss))
    got_g = _flat(tr.params_to_numpy(tree_map(lambda _: next(grads), tparams)))
    want_g = _flat(jg)
    assert got_g.keys() == want_g.keys()
    for key, want in want_g.items():
        _close(got_g[key], want, str(key))

    state = adamw.init(tparams)
    tparams, state, metrics = steps.make_lm_train(tcfg, device="cpu")(tparams, state, tbatch)
    _close(float(metrics["loss"]), float(jloss))
    _close(float(metrics["grad_norm"]), float(jgn))
    for ours, theirs in ((tr.params_to_numpy(tparams), jnew),
                         (tr.params_to_numpy(state["m"]), jstate["m"])):
        ours, theirs = _flat(ours), _flat(theirs)
        for key, want in theirs.items():
            moved = np.abs(want_g[key]) > MOVED
            _close(ours[key][moved], want[moved], str(key))


@pytest.mark.parametrize("name", list(ALL))
def test_param_counts_match_jax(name):
    """``param_count``, ``active_param_count`` and ``is_moe`` at the full
    configuration (no tensor is made) and at smoke size, where the count
    plus the norm gains and biases is the tree's size."""
    jm, tm = ALL[name]
    for ours, theirs in ((tm.make_config(), jm.make_config()), (tm.make_smoke(), jm.make_smoke())):
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
        assert ours.is_moe == theirs.is_moe
    cfg = tm.make_smoke()
    params = tr.init_params(cfg, device="cpu")
    extra = cfg.n_layers * 2 * cfg.d_model + cfg.d_model
    if cfg.qkv_bias:
        extra += cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head
    assert sum(t.numel() for t in leaves(params)) == cfg.param_count() + extra


@pytest.mark.parametrize("name", list(MOE))
def test_init_params_moe_layout_matches_jax(name):
    """In bfloat16 the experts are bare (E, d, f) / (E, f, d) bfloat16
    tensors and the router a float32 {"w": (d, E)}, on both sides; the
    port's draw has the shapes and types of JAX's."""
    jm, tm = MOE[name]
    jcfg = dataclasses.replace(jm.make_smoke(), param_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tm.make_smoke(), param_dtype=torch.bfloat16)
    jflat = _flat(jtr.init_params(jax.random.PRNGKey(0), jcfg))
    drawn = tr.init_params(tcfg, seed=0, device="cpu")
    ours = {path: leaf for path, leaf in leaves_with_paths(tr.stack_layers(drawn))}
    assert ours.keys() == jflat.keys()
    for key, want in jflat.items():
        assert tuple(ours[key].shape) == want.shape, key
        assert str(ours[key].dtype).split(".")[-1] == str(want.dtype), key
    e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    lp = drawn["layers"][0]
    assert lp["router"]["w"].dtype == torch.float32 and tuple(lp["router"]["w"].shape) == (d, e)
    assert tuple(lp["w_gate"].shape) == tuple(lp["w_up"].shape) == (e, d, f)
    assert tuple(lp["w_down"].shape) == (e, f, d) and lp["w_down"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(lp["w_down"].float().std()), f**-0.5, rtol=0.1)
    np.testing.assert_allclose(float(lp["w_gate"].float().std()), d**-0.5, rtol=0.1)


# ---------------------------------------------------------------------------
# stacked layers and checkpoints of a MoE model
# ---------------------------------------------------------------------------


def test_params_to_numpy_inverts_params_from_numpy_moe():
    jcfg, tcfg = jgranite.make_smoke(), granite_moe_1b_a400m.make_smoke()
    tree = _np_tree(jtr.init_params(jax.random.PRNGKey(1), jcfg))
    back = tr.params_to_numpy(tr.params_from_numpy(tree, tcfg, device="cpu"))
    assert _flat(back).keys() == _flat(tree).keys()
    for key, want in _flat(tree).items():
        assert _flat(back)[key].dtype == want.dtype
        np.testing.assert_array_equal(_flat(back)[key], want)
    params = tr.init_params(tcfg, seed=0, device="cpu")
    again = tr.unstack_layers(tr.stack_layers(params))
    for (pa, a), (pb, b) in zip(leaves_with_paths(params), leaves_with_paths(again)):
        assert pa == pb and torch.equal(a, b)
    assert again["layers"][1]["w_gate"].data_ptr() != params["layers"][1]["w_gate"].data_ptr()


def _moe_train_trees():
    """granite-moe-smoke in bfloat16 (router float32): the JAX (params,
    opt_state), and the port's per-layer tree from the same numbers."""
    jcfg = dataclasses.replace(jgranite.make_smoke(), param_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(granite_moe_1b_a400m.make_smoke(), param_dtype=torch.bfloat16)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = jadamw.init(jparams)
    jstate = {**jstate, "count": jnp.asarray(5, jnp.int32),
              "m": jax.tree.map(lambda x: x + 0.25, jstate["m"])}
    params = tr.params_from_numpy(_np_tree(jparams), tcfg, device="cpu")
    state = adamw.init(params)
    state["count"] = torch.tensor(5, dtype=torch.int32)
    for m in leaves(state["m"]):
        m += 0.25
    return (jparams, jstate), (params, state)


def _same(ours, theirs):
    """Every leaf of a port tree equal, bit for bit and in type, to JAX's."""
    got = {tuple(p): leaf for p, leaf in leaves_with_paths(ours)}
    want = _flat(theirs)
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        t = got[key]
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), key
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          leaf.view(np.uint16), err_msg=str(key))
        else:
            np.testing.assert_array_equal(t.numpy(), leaf, err_msg=str(key))


def test_moe_checkpoint_crosses_packages(tmp_path):
    """``launch/train.py``'s save of a MoE model (layers stacked on the host,
    bare expert leaves) restores in JAX leaf for leaf, the router float32;
    a JAX-written one restores into the port's per-layer tree by row."""
    theirs, (params, state) = _moe_train_trees()
    saved = train_cli._lm_to_ckpt(params, state)
    assert saved[0]["layers"]["router"]["w"].dtype == torch.float32
    assert tuple(saved[0]["layers"]["w_down"].shape) == (2, 4, 32, 64)
    ckpt.save(tmp_path / "port", 3, saved)
    restored, step = jckpt.restore(tmp_path / "port", jax.tree.map(jnp.zeros_like, theirs))
    assert step == 3 and restored[0]["layers"]["router"]["w"].dtype == jnp.float32
    _same(saved, restored)
    _same(saved, theirs)
    jckpt.save(tmp_path / "jax", 3, theirs)
    like = jax.tree.map(torch.zeros_like, (params, state))
    mine, _ = ckpt.restore(tmp_path / "jax", like, locate=train_cli._lm_locate)
    assert mine[0]["layers"][1]["router"]["w"].dtype == torch.float32
    _same(train_cli._lm_to_ckpt(*mine), theirs)


@pytest.fixture
def one_thread():
    """torch on one intra-op thread for the test: on more, the CPU backward
    of the embedding lookup (an accumulating index_put over repeated token
    ids) sums a row's gradients in a run-dependent order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_moe_train_resume_continues_the_uninterrupted_run(tmp_path, capsys, one_thread):
    """``launch.train --arch granite-moe-1b-a400m --smoke``: 6 steps with
    checkpoints every 3, then 8 resumed from step 6, whose losses equal those
    of one uninterrupted 8-step run, bit for bit."""
    def run(n, extra=()):
        return train_cli.main(["--arch", "granite-moe-1b-a400m", "--smoke", "--steps", str(n),
                               "--log-every", "2", "--device", "cpu", *extra])

    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "3"]
    first = run(6, ck)
    resumed = run(8, ck)
    assert "resumed from step 6" in capsys.readouterr().out
    straight = run(8)
    assert first == straight[:6] and resumed == straight[6:]


# ---------------------------------------------------------------------------
# the serving entry point
# ---------------------------------------------------------------------------


def test_serve_moe_cli_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "granite-moe-1b-a400m",
         "--smoke", "--device", "cpu", "--prompt-len", "16", "--gen", "6", "--batch", "4"],
        capture_output=True, text=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=SRC),
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("model granite-moe-smoke: prefill(4x16)")
    stats = json.loads(lines[2])
    cfg = granite_moe_1b_a400m.make_smoke()
    assert stats["params"] == cfg.param_count() and stats["gen"] == 6
    assert stats["launches"]["flash_attention"] == 0 and stats["device"] == "cpu"


# ---------------------------------------------------------------------------
# chip_smoke.py's pinned routing for the MoE twins
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_route_pin_replays_the_plain_routing():
    """``RoutePin``: a run replaying a recorded run's routing gives its
    logits and finds no token routed apart; with a perturbed router it still
    routes as recorded, and reports the tokens its own routing sends
    elsewhere with their probability gaps; a dense model is left alone."""
    cs = _chip_smoke()
    cfg = granite_moe_1b_a400m.make_smoke()
    params = tr.init_params(cfg, seed=0, device="cpu")
    toks = jpipe.LMStream(vocab=cfg.vocab, batch=4, seq=64).batch_at(0)["tokens"]
    pin = cs.RoutePin(True)
    with pin.record():
        want, _ = tr.prefill(params, toks, cfg, 64, device="cpu")
    routes = list(pin.tape)
    assert len(routes) == cfg.n_layers
    with pin.replay():
        got, _ = tr.prefill(params, toks, cfg, 64, device="cpu")
    assert torch.equal(got, want) and pin.widest() == (0, 0.0) and not pin.tape
    gen = torch.Generator().manual_seed(0)
    moved = tree_map(lambda t: t, params)
    for lp in moved["layers"]:
        lp["router"] = {"w": lp["router"]["w"] + 0.05 * torch.randn(lp["router"]["w"].shape,
                                                                     generator=gen)}
    pin.tape = list(routes)
    with pin.replay():
        tr.prefill(moved, toks, cfg, 64, device="cpu")
    n, widest = pin.widest()
    assert n > 0 and 0.0 < widest < 1.0
    dense = cs.RoutePin(False)
    qcfg = qwen2_5_3b.make_smoke()
    with dense.record():
        tr.prefill(tr.init_params(qcfg, device="cpu"), toks, qcfg, 64, device="cpu")
    assert dense.tape == [] and dense.widest() == (0, 0.0)
