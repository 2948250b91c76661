"""The port's training path on the CPU, held against the JAX package: one LM
step (qwen2.5-smoke) and one recsys step (xdeepfm-smoke) from the same
numpy parameters and batch, JAX's ``value_and_grad(loss_fn)`` and
``adamw.update`` against the port's autograd and ``adamw.update``; the
optimizer's schedule and global norm; ``MarkovLMStream``; the attention's
autograd Function; and the training driver's resume.

Tolerances (float32 throughout; the two frameworks sum in other orders):
- loss and grad_norm: rtol 1e-5.
- gradients, leaf by leaf: rtol 1e-4, atol 1e-6 x the leaf's largest |g|
  (a few float32 products summed in another order, then the backward's own
  sums; entries near 0 are held absolutely, relative to the leaf).
- trained parameters: rtol 1e-5, atol 1e-6, compared where |g| > 1e-6 in
  JAX's gradient. AdamW's first step moves each entry by lr * g / (|g| +
  eps), about lr * sign(g), so where g is near 0 the two sides may move it
  in opposite directions.
- schedule and global_norm: rtol 1e-6 (float32 formulas; a cosine from
  another libm may differ in its last bit).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_5_3b as jqwen
from repro.configs import xdeepfm as jxdeepfm
from repro.data import pipeline as jpipe
from repro.models import recsys as jrec
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro_torch.configs import qwen2_5_3b, xdeepfm
from repro_torch.data import pipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import nn, recsys as rec, transformer as tr
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.tree import leaves, leaves_with_paths, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_RTOL, PARAM_ATOL, MOVED = 1e-5, 1e-6, 1e-6


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _flat(tree) -> dict:
    """numpy leaves of a (numpy or JAX) tree by their key path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)] = np.asarray(leaf)
    return out


def _held(ours: dict, theirs: dict, jgrads: dict | None = None) -> None:
    """Every leaf of ``ours`` against ``theirs``: gradients (``jgrads`` None)
    by the gradient tolerance, parameters where JAX's gradient moved them."""
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        got = ours[key]
        assert got.shape == want.shape, key
        if jgrads is None:
            atol = GRAD_ATOL * max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol, err_msg=str(key))
        else:
            moved = np.abs(jgrads[key]) > MOVED
            np.testing.assert_allclose(got[moved], want[moved], rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=str(key))


def _step_against_jax(jparams, jbatch, jloss_fn, tparams, tbatch, tloss_fn, make_step,
                      to_numpy):
    """One JAX step and one port step from the same parameters; every
    comparison of the module docstring."""
    opt_cfg = adamw.AdamWConfig()
    jopt = jadamw.AdamWConfig()
    jloss, jg = jax.value_and_grad(jloss_fn)(jparams, jbatch)
    jnew, jstate, jgn = jadamw.update(jg, jadamw.init(jparams), jparams, jopt)

    flat = leaves(tparams)
    for p in flat:
        p.requires_grad_(True)
    loss = tloss_fn(tparams, tbatch)
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    gtree = _grad_tree(tparams, grads)
    _held(_flat(to_numpy(gtree)), _flat(jg))

    state = adamw.init(tparams)
    tparams, state, metrics = make_step(opt_cfg)(tparams, state, tbatch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jgn), rtol=LOSS_RTOL)
    assert int(state["count"]) == int(jstate["count"]) == 1
    _held(_flat(to_numpy(tparams)), _flat(jnew), _flat(jg))
    _held(_flat(to_numpy(state["m"])), _flat(jstate["m"]), _flat(jg))


def _grad_tree(params, grads):
    it = iter(grads)
    return tree_map(lambda _: next(it), params)


def test_lm_train_step_matches_jax():
    jcfg, cfg = jqwen.make_smoke(), qwen2_5_3b.make_smoke()
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    batch = jpipe.LMStream(vocab=jcfg.vocab, batch=4, seq=32).batch_at(3)
    tparams = tr.params_from_numpy(_np_tree(jparams), cfg, device="cpu")
    tbatch = {key: torch.from_numpy(val) for key, val in batch.items()}
    _step_against_jax(
        jparams, jax.tree.map(jnp.asarray, batch), lambda p, b: jtr.loss_fn(p, b, jcfg),
        tparams, tbatch, lambda p, b: tr.loss_fn(p, b, cfg, device="cpu"),
        lambda opt: steps.make_lm_train(cfg, opt, device="cpu"), tr.params_to_numpy)


def test_recsys_train_step_matches_jax():
    jcfg, cfg = jxdeepfm.make_smoke(), xdeepfm.make_smoke()
    jparams = jrec.init_params(jax.random.PRNGKey(0), jcfg)
    batch = jpipe.RecsysStream(n_sparse=jcfg.n_sparse, bag=jcfg.bag_size,
                               rows=jcfg.table_rows, batch=32).batch_at(2)
    tparams = rec.params_from_numpy(_np_tree(jparams), cfg, device="cpu")
    tbatch = {key: torch.from_numpy(val) for key, val in batch.items()}
    _step_against_jax(
        jparams, jax.tree.map(jnp.asarray, batch), lambda p, b: jrec.loss_fn(p, b, jcfg),
        tparams, tbatch, lambda p, b: rec.loss_fn(p, b, cfg, device="cpu"),
        lambda opt: steps.make_recsys_train(cfg, opt, device="cpu"), rec.params_to_numpy)


@pytest.mark.parametrize("records", [False, True], ids=["inference", "training"])
def test_cin_recomputes_its_chunks_only_when_autograd_records(monkeypatch, records):
    """The CIN goes through ``torch.utils.checkpoint`` only where autograd
    records (a parameter requires grad): inference keeps the plain chunk
    loop, and both give the same logits."""
    cfg = xdeepfm.make_smoke()
    params = rec.init_params(cfg, seed=0, device="cpu")
    batch = pipeline.RecsysStream(n_sparse=cfg.n_sparse, bag=cfg.bag_size,
                                  rows=cfg.table_rows, batch=16).batch_at(0)
    tbatch = {key: torch.from_numpy(val) for key, val in batch.items()}
    plain = rec.forward(params, tbatch, cfg, device="cpu")
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    if records:
        for p in leaves(params):
            p.requires_grad_(True)
    got = rec.forward(params, tbatch, cfg, device="cpu")
    assert bool(calls) == records
    torch.testing.assert_close(got.detach(), plain, rtol=0, atol=0)
    if records:
        rec.loss_fn(params, tbatch, cfg, device="cpu").backward()
        assert all(p.grad is not None for p in params["cin"])


def test_params_to_numpy_inverts_params_from_numpy():
    jcfg, cfg = jqwen.make_smoke(), qwen2_5_3b.make_smoke()
    tree = _np_tree(jtr.init_params(jax.random.PRNGKey(1), jcfg))
    back = tr.params_to_numpy(tr.params_from_numpy(tree, cfg, device="cpu"))
    assert _flat(back).keys() == _flat(tree).keys()
    for key, want in _flat(tree).items():
        np.testing.assert_array_equal(_flat(back)[key], want)
    params = tr.init_params(cfg, seed=0, device="cpu")
    again = tr.unstack_layers(tr.stack_layers(params))
    for (pa, a), (pb, b) in zip(leaves_with_paths(params), leaves_with_paths(again)):
        assert pa == pb and torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 1, 5, 50, 99, 100, 101, 500, 9999, 10000, 20000])
def test_schedule_matches_jax(step):
    cfg = adamw.AdamWConfig(lr=1e-3)
    got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = jadamw.schedule(jadamw.AdamWConfig(lr=1e-3), jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(4)
    tree = {"b": [rng.standard_normal((7, 5)).astype(np.float32)],
            "a": rng.standard_normal((300,)).astype(np.float32),
            "c": {"d": (100 * rng.standard_normal((3, 3))).astype(np.float32)}}
    got = adamw.global_norm(jax.tree.map(torch.from_numpy, tree))
    want = jadamw.global_norm(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1)])
def test_markov_stream_matches_jax(seed, step):
    ours = pipeline.MarkovLMStream(vocab=97, batch=5, seq=33, branching=3, seed=seed)
    theirs = jpipe.MarkovLMStream(vocab=97, batch=5, seq=33, branching=3, seed=seed)
    a, b = ours.batch_at(step), theirs.batch_at(step)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_attention_function_backward_is_the_plain_one(causal):
    """The autograd Function behind ``nn.attention`` on the card: its forward
    launches K6 there and runs the plain version on CPU tensors, and its
    backward recomputes the plain attention. On the CPU both halves are the
    plain attention's, so output and gradients equal plain autograd exactly."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    g = torch.from_numpy(rng.standard_normal((2, 40, 4, 16)).astype(np.float32))
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = nn._KernelAttention.apply(*ins, causal)
    got = torch.autograd.grad(out, ins, g)
    ref_ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want_out = nn.attention(*ref_ins, causal=causal)
    want = torch.autograd.grad(want_out, ref_ins, g)
    assert torch.equal(out, want_out)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cross_entropy_matches_jax():
    from repro.models import nn as jnn

    rng = np.random.default_rng(2)
    logits = (4 * rng.standard_normal((3, 5, 11))).astype(np.float32)
    labels = rng.integers(0, 11, size=(3, 5)).astype(np.int32)
    got = nn.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jnn.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _train(tmp, steps_: int, extra=()) -> list[float]:
    return train_cli.main(["--arch", "qwen2.5-3b", "--smoke", "--steps", str(steps_),
                           "--log-every", "2", "--device", "cpu", *extra])


def test_train_resume_continues_the_uninterrupted_run(tmp_path, capsys):
    """6 steps with checkpoints every 3, then the same command with 8 steps,
    resumed from step 6: its losses (steps 6 and 7) equal those of one
    uninterrupted 8-step run, bit for bit."""
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "3"]
    first = _train(tmp_path, 6, ck)
    resumed = _train(tmp_path, 8, ck)
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and len(first) == 6 and len(resumed) == 2
    straight = _train(tmp_path, 8)
    assert resumed == straight[6:]
    assert first == straight[:6]


def test_train_driver_resume_cli(tmp_path):
    """The JAX package's ``test_train_driver_resume``, on the port's driver."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2.5-3b",
           "--smoke", "--steps", "6", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
           "--log-every", "2", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    p1 = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
    assert p1.returncode == 0, p1.stderr
    assert "final loss" in p1.stdout
    cmd[cmd.index("--steps") + 1] = "8"
    p2 = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
    assert p2.returncode == 0, p2.stderr
    assert "resumed from step 6" in p2.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000006", "step_00000008"]


def test_train_recsys_and_refusals(tmp_path, capsys):
    """xdeepfm and egnn train (the GNN family no longer refused); the kNN
    index, which has no training step, is refused."""
    losses = train_cli.main(["--arch", "xdeepfm", "--smoke", "--steps", "3", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "final loss" in capsys.readouterr().out
    egnn_losses = train_cli.main(["--arch", "egnn", "--smoke", "--steps", "3", "--device", "cpu"])
    print("egnn --smoke losses:", egnn_losses)
    assert len(egnn_losses) == 3 and all(np.isfinite(egnn_losses))
    assert "final loss" in capsys.readouterr().out
    with pytest.raises(ValueError):
        train_cli.main(["--arch", "knn-index", "--smoke", "--device", "cpu"])
