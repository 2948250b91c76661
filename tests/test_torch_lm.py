"""The port's LM serving path on the CPU, held against the JAX package: K6
``flash_attention`` (plain version) against the JAX oracle, the Pallas kernel
in interpret mode and ``nn.chunked_attention``, also at the prefill's head
layout in both dtypes, the choice of its kernel by dtype, and the bounds
``chip_smoke.py`` holds the kernel to and the faults planted to test them
(``tools/k6_planted_faults.py``); RMSNorm and
RoPE; forward, prefill (logits and cache) and teacher-forced decode of
``qwen2.5-smoke`` with parameters carried across by ``params_from_numpy``;
the token stream; and the serving driver's command line.

Inputs are made with numpy from a seed and fed to both sides. Tolerances:
- attention in float32: rtol = atol = 2e-5 (the JAX kernel test's; online
  softmax over blocks of another size, sums in another order); in bfloat16:
  3e-2 (one rounding of p and of the output to bfloat16 on each side).
- RMSNorm, RoPE: rtol 1e-6 / atol 1e-6 (the same float32 formulas).
- logits: rtol = atol = 1e-4 (two layers of float32 products in another
  order; the logits are O(1)).
"""
import importlib.util
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
from repro.data import pipeline as jpipe
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import nn as jnn
from repro.models import transformer as jtr
from repro_torch.configs import qwen2_5_3b, registry
from repro_torch.data import pipeline
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import nn, transformer as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
LOGIT_TOL = 1e-4


def _qkv(b, s, t, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# K6 flash_attention
# ---------------------------------------------------------------------------

# the JAX kernel test's four shapes (tests/kernels/test_kernels.py), block sizes
# for the Pallas side
SHAPES = [
    (2, 32, 32, 4, 2, 8, 8, 16, True),
    (1, 64, 64, 4, 4, 16, 16, 16, False),
    (2, 16, 16, 8, 2, 8, 16, 8, True),
    (1, 48, 48, 2, 1, 32, 16, 24, True),
]


@pytest.mark.parametrize("b,s,t,h,hkv,d,bq,bk,causal", SHAPES)
def test_flash_attention_matches_jax(b, s, t, h, hkv, d, bq, bk, causal):
    q, k, v = _qkv(b, s, t, h, hkv, d, s * t)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (jref.flash_attention_ref(jq, jk, jv, causal=causal),
                 jops.flash_attention(jq, jk, jv, causal=causal, block_q=bq, block_k=bk),
                 jnn.chunked_attention(jq, jk, jv, causal=causal, q_chunk=bq, kv_chunk=bk)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16_matches_jax():
    q, k, v = _qkv(1, 32, 32, 4, 2, 16, 3)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    for want in (jref.flash_attention_ref(jq, jk, jv, causal=True),
                 jops.flash_attention(jq, jk, jv, causal=True, block_q=16, block_k=16)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("s,t,causal", [(24, 40, False), (40, 24, False), (37, 37, True),
                                        (37, 53, False), (1031, 1031, True)])
def test_flash_attention_uneven_lengths(s, t, causal):
    """S != T, and lengths no tile divides (the plain version's 1024-row
    blocks included at 1031)."""
    q, k, v = _qkv(2, s, t, 4, 2, 8, s + t)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    if s == t and s < 1024:  # the Pallas kernel wants its blocks to divide S and T
        pal = jops.flash_attention(jq, jk, jv, causal=causal, block_q=s, block_k=t)
        np.testing.assert_allclose(got, np.asarray(pal), rtol=2e-5, atol=2e-5)


# the prefill's head layout (qwen2.5-3b: 16 query heads over 2 kv heads, D =
# 128) in both of the kernel's dtypes; float32 2e-5, bfloat16 3e-2 as above
PREFILL_TOL = {np.float32: 2e-5, jnp.bfloat16: 3e-2}


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["float32", "bfloat16"])
def test_flash_attention_prefill_heads_match_jax(dtype):
    """S = T = 256 causal: the oracle and the Pallas kernel in interpret mode
    (blocks of 128, the bf16 kernel's tile)."""
    q, k, v = _qkv(1, 256, 256, 16, 2, 128, 7)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = ops.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=True)
    assert got.dtype == tdt
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    tol = PREFILL_TOL[dtype]
    for want in (jref.flash_attention_ref(jq, jk, jv, causal=True),
                 jops.flash_attention(jq, jk, jv, causal=True, block_q=128, block_k=128)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("s,t,causal", [(200, 200, True), (130, 260, False)])
def test_flash_attention_prefill_heads_uneven_match_jax(s, t, causal, dtype):
    """Lengths no 128-row tile divides, at the prefill's head layout, against
    the oracle (the Pallas kernel's blocks must divide S and T)."""
    q, k, v = _qkv(2, s, t, 16, 2, 128, s + t)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = ops.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=causal)
    want = jref.flash_attention_ref(*(jnp.asarray(x, dtype) for x in (q, k, v)), causal=causal)
    tol = PREFILL_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("h,hkv,d,kv_block", [
    pytest.param(16, 2, 128, 128, id="128"),
    pytest.param(16, 2, 128, 64, id="64"),
    pytest.param(16, 8, 64, 128, id="granite-16/8-D64-128"),
])
def test_flash_attention_ref_kv_block_rounds_as_the_pallas_block(h, hkv, d, kv_block):
    """The plain version at ``kv_block`` rounds p against the same running
    max as the Pallas kernel at ``block_k = kv_block`` (bf16, the prefill's
    head layout (16/2, D = 128) and granite-moe's (16/8, D = 64), both on the
    wgmma route's tile of 128): outputs equal but where float32 sums in
    another order move a bf16 rounding, at most 1e-3 of them, each within
    half of chip_smoke's per-element bound on the wgmma route (1e-3 + 1.6e-2
    |value|), which holds K6 to the plain version at its route's tile."""
    q, k, v = _qkv(1, 256, 256, h, hkv, d, 7)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jops.flash_attention(jq, jk, jv, causal=True, block_q=128,
                                           block_k=kv_block), np.float32)
    got = ref.flash_attention_ref(tq, tk, tv, causal=True, kv_block=kv_block).float().numpy()
    diff = np.abs(got - want)
    assert (diff > 0).mean() <= 1e-3
    assert (diff <= 0.5 * (1e-3 + 1.6e-2 * np.abs(want))).all()


@pytest.mark.parametrize("s,t,causal", [(37, 53, False), (70, 70, True), (130, 260, False)])
def test_flash_attention_ref_kv_block_matches_jax(s, t, causal):
    """float32, kv blocks no length is a multiple of: the oracle's function
    (2e-5, as above)."""
    q, k, v = _qkv(2, s, t, 4, 2, 8, s * t)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal, kv_block=16)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# the shapes of the JAX package's test_flash_attention_sweep (its blocks
# block_q, block_k for the Pallas run), and (2, 48, 48, 4/2) causal
HEAD_DIM_SHAPES = [
    ((2, 32, 32, 4, 2, True), (8, 16)),
    ((1, 64, 64, 4, 4, False), (16, 16)),
    ((2, 16, 16, 8, 2, True), (16, 8)),
    ((1, 48, 48, 2, 1, True), (16, 24)),
    ((2, 48, 48, 4, 2, True), (16, 16)),
]


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("d", ops.ATTN_HEAD_DIMS)
@pytest.mark.parametrize("shape,blocks", HEAD_DIM_SHAPES,
                         ids=[f"{b}x{s}x{t}-{h}/{hkv}-{'causal' if c else 'full'}"
                              for (b, s, t, h, hkv, c), _ in HEAD_DIM_SHAPES])
def test_flash_attention_every_head_dim_matches_jax(shape, blocks, d, dtype):
    """Every head dim K6 takes (``ATTN_HEAD_DIMS``), in both dtypes, at the
    shapes of the JAX package's flash-attention sweep, against the JAX oracle
    and the Pallas kernel in interpret mode at the sweep's blocks; float32
    2e-5, bfloat16 3e-2 as above."""
    b, s, t, h, hkv, causal = shape
    q, k, v = _qkv(b, s, t, h, hkv, d, s * t + d)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = ops.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == (b, s, h, d)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    tol = PREFILL_TOL[dtype]
    for want in (jref.flash_attention_ref(jq, jk, jv, causal=causal),
                 jops.flash_attention(jq, jk, jv, causal=causal, block_q=blocks[0],
                                      block_k=blocks[1])):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 128, ("wgmma", 1)),
    (torch.float32, 128, ("fma", 0)),
    (torch.float16, 128, TypeError),
    (torch.float64, 128, TypeError),
    (torch.bfloat16, 64, ("wgmma", 1)),
    (torch.float32, 256, ValueError),
    *[(torch.float32, d, ("fma", 0)) for d in (8, 16, 32, 64)],
    *[(torch.bfloat16, d, ("fma", 2)) for d in (8, 16, 32)],
    *[(dt, d, ValueError) for dt in (torch.float32, torch.bfloat16) for d in (4, 24, 96, 0)],
    (torch.float16, 64, TypeError),
])
def test_flash_attention_route(dtype, d, route):
    """bf16 at D = 64 and 128 goes to the tensor-core kernel; float32 at every
    head dim of ``ATTN_HEAD_DIMS``, and bf16 at D in {8, 16, 32}, to the
    CUDA-core one; any other dtype or head dim raises rather than falling
    back."""
    assert ops.ATTN_WGMMA_HEAD_DIM == (64, 128)
    if isinstance(route, tuple):
        assert ops.flash_attention_route(dtype, d) == route
    else:
        with pytest.raises(route):
            ops.flash_attention_route(dtype, d)


def test_flash_attention_masked_rows_give_zero():
    """A row with every column masked (no kv at all) gives 0, as the Pallas
    kernel's max(l, 1e-30) guard makes it."""
    q, k, v = _qkv(1, 5, 0, 2, 1, 8, 0)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    assert tuple(got.shape) == (1, 5, 2, 8) and bool((got == 0).all())


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_attention_bounds():
    """chip_smoke's K6 check, on each bf16 route: an output one bf16 ulp off
    its plain version passes both bf16 bounds; one moved as by a skipped kv
    tile (0.004 on outputs of ~0.03) passes ATTN_TOL and fails the route's
    per-element bound; float32 has ATTN_TOL alone."""
    cs = _load("chip_smoke.py", "chip_smoke")
    gen = torch.Generator().manual_seed(0)
    want = (0.03 * torch.randn(64, 128, generator=gen)).to(torch.bfloat16)
    one_ulp = (want.view(torch.int16) + 1).view(torch.bfloat16)
    assert set(cs.ATTN_ULPS_BF16) == {"wgmma", "fma"}
    for route in cs.ATTN_ULPS_BF16:
        held = cs.attn_held(one_ulp, want, route)
        assert held["tol"]["ok"] and held["ulps"]["ok"] and held["ulps"]["ratio"] <= 0.5
        held = cs.attn_held((want.float() + 0.004).to(torch.bfloat16), want, route)
        assert held["tol"]["ok"] and not held["ulps"]["ok"], route
        assert held["ulps"]["outside"] > 0 and held["ulps"]["ratio"] > 1
        assert set(cs.attn_held(want.float(), want.float(), route)) == {"tol"}


@pytest.mark.parametrize("fault", ["intact", "drop_tile", "stale_stage", "drop_tile_fma",
                                   "stale_stage_fma"])
def test_k6_planted_faults_apply_to_the_kernel(fault, tmp_path):
    """Each planted fault of tools/k6_planted_faults.py finds its text in the
    kernel source once, and edits only the copy."""
    pf = _load(os.path.join("tools", "k6_planted_faults.py"), "k6_planted_faults")
    assert set(pf.FAULTS) == {"intact", "drop_tile", "stale_stage", "drop_tile_fma",
                              "stale_stage_fma"}
    kernel = os.path.join(REPO, pf.KERNEL)
    os.makedirs(os.path.dirname(tmp_path / pf.KERNEL))
    original = open(kernel).read()
    (tmp_path / pf.KERNEL).write_text(original)
    pf.plant(str(tmp_path), pf.FAULTS[fault][1])
    planted = (tmp_path / pf.KERNEL).read_text()
    assert (planted == original) == (fault == "intact")
    assert planted.count("planted fault") == (0 if fault == "intact" else 1)
    assert open(kernel).read() == original


# ---------------------------------------------------------------------------
# layers and the model
# ---------------------------------------------------------------------------


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    got = nn.rmsnorm_apply({"g": torch.from_numpy(g)}, torch.from_numpy(x))
    want = jnn.rmsnorm_apply({"g": jnp.asarray(g)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    for pos in (np.arange(7), np.arange(100, 107), np.array([5])):
        xs = x[:, : len(pos)]
        got = nn.apply_rope(torch.from_numpy(xs), torch.from_numpy(pos), 10000.0)
        want = jnn.apply_rope(jnp.asarray(xs), jnp.asarray(pos), 10000.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_rmsnorm_init_takes_its_device():
    """No default device: a caller that forgets it is told, not put on the CPU."""
    with pytest.raises(TypeError):
        nn.rmsnorm_init(8)
    assert nn.rmsnorm_init(8, device="cpu")["g"].device.type == "cpu"


def _smoke_model(seed=0):
    jcfg, tcfg = jqwen.make_smoke(), qwen2_5_3b.make_smoke()
    jparams = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = tr.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_forward_matches_jax():
    jcfg, tcfg, jparams, tparams = _smoke_model()
    toks = pipeline.LMStream(vocab=tcfg.vocab, batch=2, seq=24).batch_at(0)["tokens"]
    want = jtr.forward(jparams, jnp.asarray(toks), jcfg)
    got = tr.forward(tparams, toks, tcfg, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("seed,batch,prompt", [(0, 2, 12), (1, 3, 21)])
def test_prefill_and_decode_match_jax(seed, batch, prompt):
    """Prefill logits and cache, then 8 teacher-forced decode steps."""
    jcfg, tcfg, jparams, tparams = _smoke_model(seed)
    toks = pipeline.LMStream(vocab=tcfg.vocab, batch=batch, seq=prompt + 8,
                             seed=seed).batch_at(0)["tokens"]
    max_len = prompt + 8
    jl, jcache = jtr.prefill(jparams, jnp.asarray(toks[:, :prompt]), jcfg, max_len)
    tl, tcache = tr.prefill(tparams, toks[:, :prompt], tcfg, max_len, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert tcache["len"] == int(jcache["len"]) == prompt
    for key in ("k", "v"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for i in range(prompt, prompt + 8):
        jl, jcache = jtr.decode_step(jparams, jcache, jnp.asarray(toks[:, i]), jcfg)
        tl, tcache = tr.decode_step(tparams, tcache, torch.from_numpy(toks[:, i]), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert tcache["len"] == prompt + 8
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    with pytest.raises(ValueError, match="full"):
        tr.decode_step(tparams, tcache, torch.from_numpy(toks[:, 0]), tcfg)


def test_configs_match_jax():
    """The five LM configurations, full and smoke, field for field (the MoE
    fields included) and in their parameter counts; the registry's
    families."""
    from repro.configs import granite_moe_1b_a400m as jgranite
    from repro.configs import internlm2_20b as jinternlm2
    from repro.configs import llama4_scout_17b_a16e as jllama4
    from repro.configs import qwen1_5_110b as jqwen15
    from repro_torch.configs import (granite_moe_1b_a400m, internlm2_20b, llama4_scout_17b_a16e,
                                     qwen1_5_110b)

    pairs = {"granite-moe-1b-a400m": (granite_moe_1b_a400m, jgranite),
             "llama4-scout-17b-a16e": (llama4_scout_17b_a16e, jllama4),
             "qwen2.5-3b": (qwen2_5_3b, jqwen),
             "internlm2-20b": (internlm2_20b, jinternlm2),
             "qwen1.5-110b": (qwen1_5_110b, jqwen15)}
    for arch, (mine, jax_mod) in pairs.items():
        assert registry.get_arch(arch).make_config is mine.make_config
        for ours, theirs in ((mine.make_config(), jax_mod.make_config()),
                             (mine.make_smoke(), jax_mod.make_smoke())):
            for field in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
                          "d_ff", "vocab", "qkv_bias", "rope_theta", "n_experts", "moe_top_k",
                          "capacity_factor", "is_moe"):
                assert getattr(ours, field) == getattr(theirs, field), (arch, field)
            assert str(ours.param_dtype).split(".")[-1] == jnp.dtype(theirs.param_dtype).name
            assert ours.param_count() == theirs.param_count()
            assert ours.active_param_count() == theirs.active_param_count()
    assert qwen2_5_3b.make_config().param_dtype == torch.bfloat16
    assert 3.3e9 < qwen2_5_3b.make_config().param_count() < 3.5e9
    assert {registry.get_arch(a).family for a in ("knn-index", "xdeepfm", "qwen2.5-3b")} == {
        "knn", "recsys", "lm"}
    assert {registry.get_arch(a).family for a in pairs} == {"lm"}
    assert registry.get_arch("gcn-cora").family == "gnn"  # ported since the GNN slice
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("no-such-arch")


def test_init_params_shapes_match_jax():
    jcfg, tcfg = jqwen.make_smoke(), qwen2_5_3b.make_smoke()
    jparams = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(0), jcfg))
    carried = tr.params_from_numpy(jparams, tcfg, device="cpu")
    drawn = tr.init_params(tcfg, seed=0, device="cpu")
    again = tr.init_params(tcfg, seed=0, device="cpu")
    flat = jax.tree.leaves_with_path(carried)
    for path, leaf in flat:
        other = drawn
        for key in path:
            other = other[key.key if hasattr(key, "key") else key.idx]
        assert other.shape == leaf.shape and other.dtype == leaf.dtype
    assert torch.equal(drawn["embed"], again["embed"])  # the seed decides
    assert len(drawn["layers"]) == tcfg.n_layers


def test_params_from_numpy_carries_bf16():
    """The full configuration's type: a JAX bfloat16 tree comes across value
    for value."""
    import dataclasses

    jcfg = dataclasses.replace(jqwen.make_smoke(), param_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(qwen2_5_3b.make_smoke(), param_dtype=torch.bfloat16)
    jparams = jtr.init_params(jax.random.PRNGKey(2), jcfg)
    tparams = tr.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    assert tparams["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tparams["embed"].float().numpy(),
                                  np.asarray(jparams["embed"], np.float32))
    np.testing.assert_array_equal(tparams["layers"][1]["wq"]["w"].float().numpy(),
                                  np.asarray(jparams["layers"]["wq"]["w"][1], np.float32))


def test_lm_stream_matches_jax():
    for kw in (dict(vocab=151936, batch=4, seq=64), dict(vocab=128, batch=3, seq=9, seed=4)):
        ours, theirs = pipeline.LMStream(**kw), jpipe.LMStream(**kw)
        for step in (0, 2):
            a, b = ours.batch_at(step), theirs.batch_at(step)
            for key in ("tokens", "labels"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_serve_lm_cli_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2.5-3b", "--smoke",
         "--device", "cpu", "--prompt-len", "16", "--gen", "6", "--batch", "3"],
        capture_output=True, text=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=SRC),
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("model qwen2.5-smoke: prefill(3x16)") and "tok/s" in lines[0]
    assert lines[1].startswith("generated token ids (first sequence): [")
    stats = json.loads(lines[2])
    assert stats["device"] == "cpu" and stats["gen"] == 6 and stats["prefill_ms"] > 0
    assert stats["launches"]["flash_attention"] == 0


def test_serve_lm_greedy_tokens_follow_the_model():
    """serve.py's greedy tokens are the argmax of the model's own prefill
    and decode logits."""
    stats = serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--prompt-len",
                        "8", "--gen", "4", "--batch", "2"])
    cfg = qwen2_5_3b.make_smoke()
    params = tr.init_params(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    logits, cache = tr.prefill(params, prompts, cfg, 12, device="cpu")
    want = [torch.argmax(logits, -1)]
    for _ in range(3):
        logits, cache = tr.decode_step(params, cache, want[-1], cfg)
        want.append(torch.argmax(logits, -1))
    assert stats["tokens"] == torch.stack(want, 1).tolist()


def test_lm_entry_points_raise_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    cfg = qwen2_5_3b.make_smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.init_params(cfg)
    params = tr.init_params(cfg, device="cpu")
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.prefill(params, toks, cfg, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.forward(params, toks, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2.5-3b", "--smoke"])
    logits, _ = tr.prefill(params, toks, cfg, 8, device="cpu")
    assert tuple(logits.shape) == (1, cfg.vocab)
