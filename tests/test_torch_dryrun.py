"""The op-level count (``launch/op_cost.py``) and the one-card dry run
(``launch/dryrun.py``) on the CPU.

The count: 2 * M * N * K for a matmul, by dtype; the twins of
``tests/launch/test_hlo_cost.py``'s two loop tests on the port's Python
loops (no trip-count correction is needed); the bytes of a known op stream;
each of K1's, K5's, K6's (and K4's) entries counting as one op, the same on
the CPU with its plain version and on ``meta``, its inner ops not counted
again.

Against the JAX package: the FLOPs of the port's step against
``hlo_cost.analyze`` of the same JAX step jitted on the 1 x 1 host mesh.
qwen2.5-3b's smoke prefill and decode are equal exactly. The others part by
amounts each test states and explains (XLA's rematerialisation and its
rewrite of width-1 products).

The dry run: ``run_cell`` writes one record with the keys
``benchmarks/roofline.py`` reads (the twin of
``test_dryrun_machinery_small_mesh``); ``--arch knn-index`` and ``--arch
xdeepfm`` at their published shapes in a subprocess; every variant knob
without a one-card counterpart raises. ``init_params`` of every family on
``meta`` gives the CPU's tree of shapes and dtypes, and the CPU's draws are
the ones taken before the meta generator existed.
"""
import hashlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.distributed.sharding import make_rules
from repro.launch.hlo_cost import analyze
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, op_cost
from repro_torch.models import recsys as rc
from repro_torch.models import transformer as tr
from repro_torch.models.gnn import egnn, gcn, mace, nequip
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.tree import leaves, leaves_with_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _count(fn, *args):
    with op_cost.count() as c:
        out = fn(*args)
    return c, out


def _jax_flops(fn, *args) -> float:
    return analyze(jax.jit(fn).lower(*args).compile().as_text())["flops"]


# ---------------------------------------------------------------------------
# the count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_flops_by_dtype(dtype):
    a = torch.ones((48, 40), dtype=dtype)
    b = torch.ones((40, 24), dtype=dtype)
    c, _ = _count(lambda: (a @ b, torch.einsum("ik,kj->ij", a, b)))
    name = str(dtype).removeprefix("torch.")
    assert dict(c.flops_by_dtype) == {name: 2 * 2 * 48 * 40 * 24}
    rate = op_cost.OPS_PER_S[name]
    assert c.roofline_terms_s()["compute_s"] == pytest.approx(c.flops / rate)
    assert c.roofline_terms_s()["collective_s"] == 0.0


def test_python_loop_needs_no_trip_count_correction():
    """hlo_cost's scan test: XLA counts a 32-trip loop body once and hlo_cost
    multiplies it back; a Python loop dispatches every trip."""
    x = torch.zeros((64, 128))
    w = torch.zeros((32, 128, 128))

    def loop(x, w):
        for i in range(32):
            x = x @ w[i]
        return x

    c, _ = _count(loop, x, w)
    assert c.flops == 2 * 64 * 128 * 128 * 32


def test_nested_python_loops_multiply():
    x = torch.zeros((16, 16))
    w = torch.zeros((4, 16, 16))

    def fn(x, w):
        for _ in range(5):
            for i in range(4):
                x = x @ w[i]
        return x

    c, _ = _count(fn, x, w)
    assert c.flops == 2 * 16 * 16 * 16 * 4 * 5


def test_bytes_of_a_known_op_stream():
    x = torch.ones((100,), dtype=torch.float32)
    y = torch.ones((100,), dtype=torch.float32)

    def stream(x, y):
        z = x + y                 # 400 + 400 read, 400 written
        v = z.view(10, 10)        # a view: nothing
        s = v.sum()               # 400 read, 4 written
        h = z.to(torch.float16)   # 400 read, 200 written
        e = torch.empty((50,))    # an allocation: nothing
        g = table[rows]           # a gather: 2 x 80 of the table read, 80 written
        return s, h, e, g

    table = torch.ones((1000, 10), dtype=torch.float32)
    rows = torch.tensor([3, 7], dtype=torch.int64)
    c, _ = _count(stream, x, y)
    assert c.bytes == 1200 + 404 + 600 + (2 * 80 + 80)
    assert c.ops == 6 and c.flops == 0


def _k1(dev):
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(-1, 500, (64, 300), generator=g, dtype=torch.int32)
    d = torch.rand((64, 300), generator=g)
    return (ops.topk_merge, (ids.to(dev), d.to(dev), 20), {},
            64 * 300 * 8 + 64 * 20 * 8, 0)


def _k5(dev):
    s = torch.rand((3, 5000), generator=torch.Generator().manual_seed(1))
    return ops.retrieval_topk, (s.to(dev), 100), {}, 3 * 5000 * 4 + 3 * 100 * 8, 0


def _k6(dev):
    g = torch.Generator().manual_seed(2)
    q = torch.randn((2, 40, 4, 16), generator=g)
    k = torch.randn((2, 56, 2, 16), generator=g)
    v = torch.randn((2, 56, 2, 16), generator=g)
    moved = 4 * (q.numel() * 2 + k.numel() + v.numel())
    return (ops.flash_attention, (q.to(dev), k.to(dev), v.to(dev)), {"causal": True}, moved,
            4 * 2 * 40 * 4 * 56 * 16)


def _k4(dev):
    g = torch.Generator().manual_seed(3)
    a = torch.rand((30, 50), generator=g)
    b = torch.rand((50, 20), generator=g)
    return ops.minplus_matmul, (a.to(dev), b.to(dev)), {}, 4 * (1500 + 1000 + 600), 2 * 30 * 50 * 20


@pytest.mark.parametrize("make", [_k1, _k5, _k6, _k4], ids=["K1", "K5", "K6", "K4"])
def test_kernel_entry_counts_the_same_plain_and_on_meta(make):
    counts = {}
    for dev in ("cpu", "meta"):
        fn, args, kwargs, moved, flops = make(dev)
        c, out = _count(lambda: fn(*args, **kwargs))
        assert c.ops == 1, "the plain version's own ops are not counted again"
        assert (c.bytes, c.flops) == (moved, flops)
        assert c.kernels == {fn.__name__: {"calls": 1, "flops": flops, "bytes": moved}}
        counts[dev] = c.as_dict()
        outs = out if isinstance(out, tuple) else (out,)
        counts[dev + "_shapes"] = [(tuple(t.shape), t.dtype) for t in outs]
        assert all(t.device.type == dev for t in outs)
    assert counts["cpu"] == counts["meta"]
    assert counts["cpu_shapes"] == counts["meta_shapes"]


def _small_cells():
    """The steps the card runs in chip_smoke.py's cells phase, at small
    shapes, and a GNN step at two of its published shapes: (arch spec, shape,
    cell)."""
    import dataclasses

    from repro_torch.configs.common import ShapeCell

    smoke = lambda arch_id: dataclasses.replace(registry.get_arch(arch_id),
                                                make_config=registry.get_arch(arch_id).make_smoke)
    knn, rec = smoke("knn-index"), smoke("xdeepfm")
    f, bag = rec.make_config().n_sparse, rec.make_config().bag_size
    out = {
        "knn-build": (knn, "build_sweep", knn.shapes["build_sweep"]),
        "knn-serve": (knn, "serve_batch", knn.shapes["serve_batch"]),
        "xdeepfm-forward": (rec, "serve_p99", ShapeCell("forward", lambda c: {
            "sparse_ids": ((64, f, bag), torch.int32), "labels": ((64,), torch.int32)})),
        "xdeepfm-retrieval": (rec, "retrieval_cand", ShapeCell("retrieval", lambda c: {
            "sparse_ids": ((1, f, bag), torch.int32), "n_candidates": 50})),
    }
    gcn = registry.get_arch("gcn-cora")
    for shape in ("full_graph_sm", "molecule"):  # node labels; species and graph ids
        out[f"gcn-cora-{shape}"] = (gcn, shape, gcn.shapes[shape])
    for arch_id in ("qwen2.5-3b", "granite-moe-1b-a400m"):
        lm = smoke(arch_id)
        out[f"{arch_id}-prefill"] = (lm, "prefill_32k", ShapeCell("prefill", lambda c: {
            "tokens": ((2, 64), torch.int32), "max_len": 64}))
        out[f"{arch_id}-decode"] = (lm, "decode_32k", ShapeCell("decode", lambda c: {
            "tokens": ((4,), torch.int32), "cache_batch": 4, "cache_len": 64}))
    return out


@pytest.mark.parametrize("case", sorted(_small_cells()))
def test_step_counts_the_same_with_values_and_on_meta(case):
    """The count's contract for the cells the card runs: the step on real
    tensors (here the CPU, there the card, kernels paused alike) counts what
    it counts on meta, op for op."""
    arch, shape, cell = _small_cells()[case]
    got = {}
    for dev in ("cpu", "meta"):
        step, args, _ = dryrun.build_cell(arch, shape, cell, device=dev)
        got[dev] = dryrun.count_step(step, args)[0].as_dict()
    assert got["cpu"] == got["meta"]
    assert got["meta"]["bytes"] > 0


def test_counts_nest_and_an_outer_count_sees_the_inner_ones_ops():
    a = torch.ones((8, 8))
    ids, d = torch.zeros((2, 8), dtype=torch.int32), torch.zeros((2, 8))
    with op_cost.count() as outer:
        _ = a @ a
        with op_cost.count() as inner:
            ops.topk_merge(ids, d, 3)
    assert inner.ops == 1 and inner.flops == 0
    assert outer.ops == 2 and outer.flops == 2 * 8 * 8 * 8
    assert outer.kernels == inner.kernels == {"topk_merge": {"calls": 1, "flops": 0,
                                                             "bytes": 2 * 8 * 8 + 2 * 3 * 8}}
    assert ops.COUNTS == []


# ---------------------------------------------------------------------------
# against hlo_cost of the JAX steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rules():
    return make_rules(make_host_mesh())


@pytest.fixture(scope="module")
def qwen_smoke():
    jcfg = __import__("repro.configs.qwen2_5_3b", fromlist=["x"]).make_smoke()
    return jcfg, registry.get_arch("qwen2.5-3b").make_smoke()


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_prefill_flops_equal_hlo_cost(qwen_smoke, rules, dev):
    jcfg, tcfg = qwen_smoke
    fn, *_ = jsteps.make_lm_prefill(jcfg, rules, 64)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    want = _jax_flops(fn, jparams, jnp.zeros((2, 64), jnp.int32))
    assert want == 19_955_712
    step = steps.make_lm_prefill(tcfg, 64, device=dev)
    with torch.no_grad():
        c, _ = _count(step, tr.init_params(tcfg, device=dev),
                      torch.zeros((2, 64), dtype=torch.int32, device=dev))
    assert c.flops == want
    assert c.kernels["flash_attention"]["calls"] == tcfg.n_layers


def test_decode_flops_equal_hlo_cost(qwen_smoke, rules):
    jcfg, tcfg = qwen_smoke
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    fn, *_ = jsteps.make_lm_decode(jcfg, rules, 2, 64)
    jcache = jtr.init_cache(jcfg, 2, 64)
    want = _jax_flops(fn, jparams, jcache, jnp.zeros((2,), jnp.int32))
    step = steps.make_lm_decode(tcfg, 2, 64, device="meta")
    c, _ = _count(step, tr.init_params(tcfg, device="meta"),
                  tr.init_cache(tcfg, 2, 64, device="meta"),
                  torch.zeros((2,), dtype=torch.int32, device="meta"))
    assert c.flops == want == 344_064


def test_lm_train_flops_against_hlo_cost(qwen_smoke):
    """JAX's make_lm_train fails under jax 0.9 (its forward constrains to
    Explicit mesh axes), so the JAX side is the function it wraps with
    rules=None. JAX rematerialises each layer in the backward
    (``jax.checkpoint``, remat_policy "full"): it runs every matmul of the
    layer's forward a second time except the down projection, whose output
    the backward does not need. The port keeps the forward's activations
    and recomputes only the attention (K6's backward differentiates the
    plain attention), which both count at 4x its forward. So JAX counts
    exactly one forward of the layers' q, k, v, o, gate and up projections
    more: port = JAX - that, a ratio of 0.848 here."""
    jcfg, tcfg = qwen_smoke
    b, s = 2, 64

    def jstep(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jtr.loss_fn)(params, batch, jcfg, None)
        params, opt_state, gnorm = jadamw.update(grads, opt_state, params,
                                                 jadamw.AdamWConfig())
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    batch = {"tokens": jnp.zeros((b, s), jnp.int32), "labels": jnp.zeros((b, s), jnp.int32)}
    want = _jax_flops(jstep, jparams, jadamw.init(jparams), batch)
    params = tr.init_params(tcfg, device="meta")
    tb = {key: torch.zeros((b, s), dtype=torch.int32, device="meta") for key in batch}
    c, _ = _count(steps.make_lm_train(tcfg, device="meta"), params, adamw.init(params), tb)
    d, hd = tcfg.d_model, tcfg.d_head
    remat = 2 * b * s * tcfg.n_layers * (d * tcfg.n_heads * hd + 2 * d * tcfg.n_kv_heads * hd
                                         + tcfg.n_heads * hd * d + 2 * d * tcfg.d_ff)
    print(f"lm train: port {c.flops} / hlo_cost {want:.0f} = {c.flops / want:.4f}")
    assert c.flops == want - remat
    assert c.flops / want == pytest.approx(0.8481, abs=1e-4)


def test_recsys_forward_flops_equal_hlo_cost(rules):
    """xdeepfm's forward: the same matmuls on both sides, ratio 1."""
    from repro.configs import xdeepfm as jx
    from repro.models import recsys as jrc

    jcfg, tcfg = jx.make_smoke(), registry.get_arch("xdeepfm").make_smoke()
    fn, *_ = jsteps.make_recsys_forward(jcfg, rules)
    batch = {"sparse_ids": jnp.zeros((64, jcfg.n_sparse, jcfg.bag_size), jnp.int32),
             "labels": jnp.zeros((64,), jnp.int32)}
    want = _jax_flops(fn, jrc.init_params(jax.random.PRNGKey(0), jcfg), batch)
    tb = {"sparse_ids": torch.zeros((64, tcfg.n_sparse, tcfg.bag_size), dtype=torch.int32,
                                    device="meta")}
    c, _ = _count(steps.make_recsys_forward(tcfg, device="meta"),
                  rc.init_params(tcfg, device="meta"), tb)
    print(f"xdeepfm forward: port {c.flops} / hlo_cost {want:.0f} = {c.flops / want:.4f}")
    assert c.flops == want


def test_gnn_train_flops_against_hlo_cost(rules):
    """gcn-cora at ``molecule`` (4,096 padded nodes, 16 -> 16 -> 1): XLA
    rewrites one of the last layer's width-1 products (a (4096, 16) x (16, 1)
    dot in the backward) as a multiply and reduce, which hlo_cost does not
    count as a dot; the port counts it. port = JAX + 2 * 4096 * 16, a ratio
    of 1.02."""
    from repro.configs import gcn_cora as jgc
    from repro.configs.common import gnn_shapes as jgnn_shapes
    from repro.models.gnn import gcn as jgcn

    jcfg = jgc.make_config("molecule")
    jparams = jgcn.init_params(jax.random.PRNGKey(0), jcfg)
    specs = jgnn_shapes()["molecule"].specs(jcfg)
    batch = {k: jnp.zeros(v.shape, v.dtype) for k, v in specs.items()}
    fn, *_ = jsteps.make_gnn_train("gcn-cora", jcfg, rules, batch)
    want = _jax_flops(fn, jparams, jadamw.init(jparams), batch)
    arch = registry.get_arch("gcn-cora")
    step, args, _ = dryrun.build_cell(arch, "molecule", arch.shapes["molecule"])
    c, _ = _count(step, *args)
    print(f"gcn-cora molecule: port {c.flops} / hlo_cost {want:.0f} = {c.flops / want:.4f}")
    assert c.flops == want + 2 * 4096 * 16
    assert c.flops / want == pytest.approx(1.02)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def test_run_cell_writes_one_record(tmp_path):
    arch = registry.get_arch("gcn-cora")
    rec = dryrun.run_cell(arch, "molecule", arch.shapes["molecule"], out_dir=tmp_path)
    files = list(tmp_path.glob("*.json"))
    assert [f.name for f in files] == ["gcn-cora__molecule__1xH100.json"]
    assert json.loads(files[0].read_text()) == json.loads(json.dumps(rec))
    for key in ("arch", "shape", "kind", "variant", "tag", "mesh", "n_chips", "per_device",
                "roofline_terms_s", "bottleneck", "flops_by_dtype", "kernels", "trace_s",
                "memory", "ops"):
        assert key in rec, key
    assert rec["mesh"] == "1xH100" and rec["n_chips"] == 1 and rec["kind"] == "train"
    assert rec["per_device"]["flops"] > 0 and rec["per_device"]["collective_bytes"] == 0
    assert rec["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    assert rec["memory"]["state_bytes"] > 0


def test_run_cell_counts_the_kernels_of_the_path(tmp_path):
    for arch_id, shape, kernel in [("knn-index", "build_sweep", "topk_merge"),
                                   ("xdeepfm", "retrieval_cand", "retrieval_topk"),
                                   ("qwen2.5-3b", "prefill_32k", "flash_attention")]:
        arch = registry.get_arch(arch_id)
        rec = dryrun.run_cell(arch, shape, arch.shapes[shape], out_dir=tmp_path)
        calls = 36 if kernel == "flash_attention" else 1
        assert rec["kernels"][kernel]["calls"] == calls, (arch_id, shape)
    assert len(list(tmp_path.glob("*.json"))) == 3


@pytest.mark.parametrize("arch_id", ["knn-index", "xdeepfm"])
def test_dryrun_cli_at_published_shapes(arch_id, tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           arch_id, "--out", str(tmp_path)],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = len(registry.get_arch(arch_id).shapes)
    assert proc.stdout.count("OK    ") == n and "FAIL" not in proc.stdout
    assert len(list(tmp_path.glob("*.json"))) == n


@pytest.mark.parametrize("knob", sorted(dryrun.NO_COUNTERPART) + ["no_such_knob"])
def test_variant_knob_without_counterpart_raises(knob):
    arch = registry.get_arch("qwen2.5-3b")
    with pytest.raises(ValueError, match=knob):
        dryrun.build_cell(arch, "decode_32k", arch.shapes["decode_32k"], {knob: "1"})


def test_supported_variant_knobs_act():
    knn = registry.get_arch("knn-index")
    fn, args, _ = dryrun.build_cell(knn, "build_sweep", knn.shapes["build_sweep"],
                                    {"knn_contig": "1"})
    assert args[0] == 0 and len(args) == 7
    gnn = registry.get_arch("gcn-cora")
    _, args, _ = dryrun.build_cell(gnn, "molecule", gnn.shapes["molecule"], {"gnn_bf16": "1"})
    assert {p.dtype for p in leaves(args[0])} == {torch.bfloat16}
    moe = registry.get_arch("granite-moe-1b-a400m")
    flops = {}
    for factor in ("1.25", "4.0"):
        step, args, _ = dryrun.build_cell(moe, "decode_32k", moe.shapes["decode_32k"],
                                          {"capacity_factor": factor})
        flops[factor] = _count(step, *args)[0].flops
    assert flops["4.0"] > flops["1.25"]  # wider expert capacity, more expert rows


# ---------------------------------------------------------------------------
# init_params on meta
# ---------------------------------------------------------------------------

_INIT = {"qwen2.5-3b": tr, "granite-moe-1b-a400m": tr, "xdeepfm": rc, "gcn-cora": gcn,
         "egnn": egnn, "nequip": nequip, "mace": mace}
# sha256 of the CPU draws (seed 3, smoke configs, leaves in tree order as
# float32 bytes), taken before init_params learned to draw for meta
_DRAWS = {
    "qwen2.5-3b": "d2b0aba73a2d0f9061ea63b8a01b2f61",
    "granite-moe-1b-a400m": "88d98c767ad542954a5783b9e15c9ee4",
    "xdeepfm": "d7823a9b911c59ad4a20c1494b4b29c4",
    "gcn-cora": "cc68f2e89c67be67233309298abe7bb2",
    "egnn": "20c0c9b93c3ab5b753ffee852edf35e1",
    "nequip": "830e23340221b7167ce6c17e52cc6aaa",
    "mace": "6a09eaae10d1051a91af46643d96a347",
}


@pytest.mark.parametrize("arch_id", sorted(_INIT))
def test_init_params_on_meta_matches_cpu_tree(arch_id):
    cfg = registry.get_arch(arch_id).make_smoke()
    cpu = _INIT[arch_id].init_params(cfg, seed=3, device="cpu")
    meta = _INIT[arch_id].init_params(cfg, seed=3, device="meta")
    shapes = lambda tree: [(path, tuple(t.shape), t.dtype) for path, t in leaves_with_paths(tree)]
    assert shapes(meta) == shapes(cpu)
    assert all(t.is_meta for t in leaves(meta))
    h = hashlib.sha256()
    for leaf in leaves(cpu):
        h.update(leaf.detach().float().contiguous().numpy().tobytes())
    assert h.hexdigest()[:32] == _DRAWS[arch_id]
