"""The port's checkpoint manager and step timer, as
``tests/distributed/test_checkpoint.py`` and ``test_units.py`` test the JAX
package's, and checkpoints crossing between the two packages both ways
(float32, int32 and bfloat16 leaves, the layout of the training driver's
``(params, opt_state)`` tree): every leaf restored bit for bit."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import qwen2_5_3b as jqwen
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import qwen2_5_3b
from repro_torch.distributed.straggler import StepTimer, pace_flag, quorum_ok
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw
from repro_torch.tree import leaves, leaves_with_paths


def _tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones((5,), dtype=torch.bfloat16),
                   "c": torch.tensor(3, dtype=torch.int32)},
    }


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 7, t)
    restored, step = ckpt.restore(tmp_path, t)
    assert step == 7
    for a, b in zip(leaves(t), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_and_prune(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4):
        ckpt.save(tmp_path, s, t)
    assert ckpt.latest_step(tmp_path) == 4
    ckpt.prune(tmp_path, keep=2)
    assert ckpt.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003", "step_00000004"]


def test_incomplete_tmp_dir_ignored(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 5, t)
    # a crash mid-save: a tmp dir without a manifest
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ckpt.latest_step(tmp_path) == 5
    restored, step = ckpt.restore(tmp_path, t)
    assert step == 5


def test_dtype_restored_via_like(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 1, t)
    like = {"a": t["a"].double(), "nested": t["nested"]}
    restored, _ = ckpt.restore(tmp_path, like)
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert restored["a"].dtype == torch.float64
    assert torch.equal(restored["a"], t["a"].double())


def test_restore_without_a_checkpoint_raises(tmp_path):
    assert ckpt.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, _tree())


def test_step_timer_deadline():
    t = StepTimer(tolerance=2.0, alpha=0.5)
    assert t.deadline == float("inf")
    t.update(1.0)
    t.update(1.0)
    assert abs(t.mean - 1.0) < 1e-9
    assert abs(t.deadline - 2.0) < 1e-9


def test_quorum():
    assert quorum_ok(0.97, quorum=0.95)
    assert not quorum_ok(0.90, quorum=0.95)
    assert quorum_ok(torch.tensor(0.96), quorum=0.95)
    import time

    assert float(pace_flag(time.monotonic(), 60.0)) == 1.0
    assert float(pace_flag(time.monotonic() - 5.0, 1.0)) == 0.0


def _driver_trees(dtype):
    """The training driver's checkpoint tree, (params, opt_state) with the
    layers stacked, from the same numpy parameters on both sides."""
    jcfg = jqwen.make_smoke()
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "param_dtype": dtype})
    cfg = qwen2_5_3b.make_smoke()
    cfg = cfg.__class__(**{**cfg.__dict__, "param_dtype": getattr(torch, jnp.dtype(dtype).name)})
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = jadamw.init(jparams)
    jstate = {**jstate, "count": jnp.asarray(5, jnp.int32),
              "m": jax.tree.map(lambda x: x + 0.25, jstate["m"])}
    params = tr.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    state = adamw.init(params)
    state["count"] = torch.tensor(5, dtype=torch.int32)
    for m in leaves(state["m"]):
        m += 0.25
    ours = (tr.stack_layers(params), {**state, "m": tr.stack_layers(state["m"]),
                                      "v": tr.stack_layers(state["v"])})
    return (jparams, jstate), ours, (params, state)


def _same(ours, theirs):
    got = {tuple(p): leaf for p, leaf in leaves_with_paths(ours)}
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(theirs)[0]}
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        t = got[key]
        if t.dtype == torch.bfloat16:
            assert str(leaf.dtype) == "bfloat16"
            a = t.view(torch.int16).numpy().view(np.uint16)
            b = np.asarray(leaf).view(np.uint16)
        else:
            a, b = t.numpy(), np.asarray(leaf)
            assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=str(key))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype):
    theirs, ours, _ = _driver_trees(dtype)
    jckpt.save(tmp_path, 12, theirs)
    like = jax.tree.map(torch.zeros_like, ours)
    restored, step = ckpt.restore(tmp_path, like)
    assert step == 12
    _same(restored, theirs)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax(tmp_path, dtype):
    theirs, ours, _ = _driver_trees(dtype)
    ckpt.save(tmp_path, 4, ours)
    like = jax.tree.map(jnp.zeros_like, theirs)
    restored, step = jckpt.restore(tmp_path, like)
    assert step == 4
    _same(ours, restored)
    # the two packages write the same archive keys, shapes and dtypes
    jckpt.save(tmp_path / "jax", 4, theirs)
    import json

    mine = json.load(open(tmp_path / "step_00000004" / "manifest.json"))
    jaxs = json.load(open(tmp_path / "jax" / "step_00000004" / "manifest.json"))
    assert mine["leaves"] == jaxs["leaves"] and mine["step"] == jaxs["step"]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["float32", "bfloat16"])
def test_driver_saves_stacked_on_the_host_and_restores_by_row(tmp_path, dtype):
    """The training driver's own save and restore of the LM: the layers are
    stacked on the host (``_lm_to_ckpt``), JAX reads the directory, and the
    port restores a JAX-written one straight into its per-layer tree
    (``_lm_locate``), every leaf bit for bit."""
    theirs, _, (params, state) = _driver_trees(dtype)
    saved = train_cli._lm_to_ckpt(params, state)
    assert all(t.device.type == "cpu" for t in leaves(saved[0]["layers"]))
    ckpt.save(tmp_path / "port", 3, saved)
    restored, _ = jckpt.restore(tmp_path / "port", jax.tree.map(jnp.zeros_like, theirs))
    _same(saved, restored)
    _same(saved, theirs)
    jckpt.save(tmp_path / "jax", 3, theirs)
    like = jax.tree.map(torch.zeros_like, (params, state))
    mine, step = ckpt.restore(tmp_path / "jax", like, locate=train_cli._lm_locate)
    assert step == 3 and len(mine[0]["layers"]) == len(params["layers"])
    _same(train_cli._lm_to_ckpt(*mine), theirs)
