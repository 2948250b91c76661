"""The single-process twins of ``repro/distributed/*`` and
``repro/launch/mesh.py`` on the CPU, held against the JAX package.

``quantize_int8`` bit for bit against JAX's on seeded inputs and on exact .5
ties (both round half to even); the compressed reduce over R = 8 replicated
replicas against JAX's ``COMPRESSION`` subprocess (8 forced host devices,
``tests/distributed/test_distributed.py``): the means and residuals within 1
ulp of the scale (the 8 scales are summed in another order by JAX's psum
and the port's), and error feedback shrinking the two-step error on both
sides; the elastic shrink of ``test_elastic_shrink_and_reshard`` on a
logical mesh, with a checkpoint saved and restored through the port's
manager; and ``ShardingRules``' sizes, ``ax`` and ``divisible_fsdp_axis``
against JAX's over ``jax.sharding.AbstractMesh`` (no devices needed) for the
meshes (4, 2), (2, 2, 2), (16, 16) and (2, 16, 16).

What one process cannot show, and no test here pretends to: real placement
on a mesh (``ShardingRules.sharding`` raises) and collectives between
processes (``compression.psum`` is the seam where they would go).
"""
import numpy as np
import pytest
import torch
from conftest import run_devices_subprocess
from jax.sharding import AbstractMesh

from repro.distributed import compression as jcomp
from repro.distributed import sharding as jsharding
from repro_torch.checkpoint import manager as ckpt
from repro_torch.distributed import compression, elastic, sharding
from repro_torch.launch import mesh


def test_quantize_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((64, 64)), dtype=torch.float32)
    q, scale = compression.quantize_int8(x)
    back = compression.dequantize_int8(q, scale)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert float((back - x).abs().max()) <= float(scale) * 0.5 + 1e-6  # half a step


def _tie_input():
    """127 at the max, so the scale is 1 + 1e-12 -> 1.0 in float32, and every
    entry k + 0.5 lies on an exact tie."""
    x = np.arange(-20, 20, dtype=np.float32) + 0.5
    return np.concatenate([x, np.float32([127.0, -126.5, 2.5, 3.5])])


@pytest.mark.parametrize("case", ["normal", "uniform", "ties", "tiny"])
def test_quantize_int8_equals_jax(case):
    rng = np.random.default_rng(5)
    x = {"normal": rng.standard_normal((33, 17)),
         "uniform": rng.uniform(-3, 3, (1000,)),
         "ties": _tie_input(),
         "tiny": rng.standard_normal((8, 8)) * 1e-30}[case].astype(np.float32)
    jq, jscale = jcomp.quantize_int8(x)
    q, scale = compression.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.item() == float(jscale)
    np.testing.assert_array_equal(compression.dequantize_int8(q, scale).numpy(),
                                  np.asarray(jcomp.dequantize_int8(jq, jscale)))
    if case == "ties":  # round half to even
        assert scale.item() == 1.0
        assert q[:40].tolist() == [int(np.round(v)) for v in x[:40]]


_COMPRESSION = r"""
import jax, numpy as np, jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.distributed.compression import make_compressed_grad_reduce

assert len(jax.devices()) == 8
mesh = make_mesh((8,), ("data",))
reduce_fn = make_compressed_grad_reduce(mesh, ("data",))
rng = np.random.default_rng(0)
g = {"w": jnp.asarray(rng.standard_normal((32, 32)), jnp.float32)}
r = {"w": jnp.zeros((32, 32), jnp.float32)}
with mesh:
    mean1, r1 = reduce_fn(g, r)
    mean2, r2 = reduce_fn(g, r1)
np.savez(OUT, g=np.asarray(g["w"]),
         mean1=np.asarray(mean1["w"]), r1=np.asarray(r1["w"]), mean2=np.asarray(mean2["w"]))
print("COMPRESSION_SAVED")
"""


def test_compressed_reduce_equals_jax_eight_devices(tmp_path):
    out = tmp_path / "jax.npz"
    text = run_devices_subprocess(f"OUT = {str(out)!r}\n" + _COMPRESSION, n_devices=8)
    assert "COMPRESSION_SAVED" in text
    want = np.load(out)
    g = torch.from_numpy(want["g"])
    reduce_fn = compression.make_compressed_grad_reduce(8)
    mean1, r1 = reduce_fn({"w": g}, {"w": torch.zeros_like(g)})
    mean2, _ = reduce_fn({"w": g}, r1)
    scale = float(compression.quantize_int8(g)[1])
    # a mean is (sum of 8 int8 payloads) * (scale sum / 8) / 8, at most 127
    # steps of the scale; a scale sum 1 ulp apart moves it by at most 127 ulps
    # of the scale, and the residual (corrected - q * scale) by one
    ulp = float(np.spacing(np.float32(scale)))
    for got, key, bound in ((mean1["w"], "mean1", 127 * ulp), (r1["w"], "r1", ulp),
                            (mean2["w"], "mean2", 127 * ulp)):
        diff = np.abs(got.numpy() - want[key]).max()
        print(f"{key}: max |port - jax| = {diff:.3e} (1 ulp of the scale {ulp:.3e})")
        assert diff <= bound, key
    err1 = {"jax": np.abs(want["mean1"] - want["g"]).max(),
            "port": float((mean1["w"] - g).abs().max())}
    err2 = {"jax": np.abs((want["mean1"] + want["mean2"]) / 2 - want["g"]).max(),
            "port": float(((mean1["w"] + mean2["w"]) / 2 - g).abs().max())}
    for side in ("jax", "port"):
        assert err1[side] < 0.05 and err2[side] < err1[side], (side, err1, err2)


def test_compressed_psum_mean_over_distinct_replicas():
    """Replicas that differ: the int32 sum of their payloads and the sum of
    their scales, each replica keeping its own residual."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((4, 10)), dtype=torch.float32)
    res = torch.tensor(rng.standard_normal((4, 10)) * 0.01, dtype=torch.float32)
    mean, new_res = compression.compressed_psum_mean(x, res)
    qs, scales = zip(*(compression.quantize_int8(c) for c in x + res))
    summed = sum(q.to(torch.int32) for q in qs)
    scale_sum = scales[0] + scales[1] + scales[2] + scales[3]
    assert torch.equal(mean, summed.float() * (scale_sum / 4.0) / 4.0)
    for i in range(4):
        assert torch.equal(new_res[i], (x[i] + res[i])
                           - compression.dequantize_int8(qs[i], scales[i]))


def test_elastic_shrink_and_reshard(tmp_path):
    mesh8 = mesh.make_mesh((4, 2), ("data", "model"))
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    ckpt.save(tmp_path, 3, {"x": x})
    surv = elastic.simulate_failures(list(mesh8.device_ids), lost=4)
    assert surv == [0, 1, 2, 3]
    mesh4 = elastic.surviving_mesh(surv, model_axis=2)
    assert mesh4.shape == {"data": 2, "model": 2}
    assert mesh4.devices.tolist() == [[0, 1], [2, 3]]
    restored, step = ckpt.restore(tmp_path, {"x": torch.zeros_like(x)})
    assert step == 3 and torch.equal(restored["x"], x)
    assert elastic.global_batch_for(mesh4, per_device_batch=4) == 8


def test_surviving_mesh_keeps_model_axis_and_power_of_two_data():
    assert elastic.surviving_mesh(list(range(14)), model_axis=2).shape == {"data": 4, "model": 2}
    assert elastic.surviving_mesh(list(range(15)), model_axis=4).shape == {"data": 2, "model": 4}
    with pytest.raises(ValueError, match="cannot keep model axis 4"):
        elastic.surviving_mesh([0, 1, 2], model_axis=4)


_MESHES = {"4x2": ((4, 2), ("data", "model")),
           "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
           "16x16": ((16, 16), ("data", "model")),
           "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("name", sorted(_MESHES))
def test_sharding_rules_equal_jax(name):
    shape, axes = _MESHES[name]
    jrules = jsharding.make_rules(AbstractMesh(shape, axes))
    rules = sharding.make_rules(mesh.make_mesh(shape, axes))
    assert (rules.fsdp, rules.tp, rules.batch) == (jrules.fsdp, jrules.tp, jrules.batch)
    assert (rules.tp_size, rules.fsdp_size, rules.batch_size_divisor) == (
        jrules.tp_size, jrules.fsdp_size, jrules.batch_size_divisor)
    for dim in (1, 2, 3, 4, 8, 12, 16, 32, 40, 128, 151936, 256, 512, 1000):
        assert rules.heads_axis(dim) == jrules.heads_axis(dim)
        assert sharding.divisible_fsdp_axis(rules, dim) == jsharding.divisible_fsdp_axis(
            jrules, dim)
        for axis in (None, "model", "data", ("pod", "data"), ("data", "model")):
            if axis and any(a not in axes for a in ((axis,) if isinstance(axis, str) else axis)):
                continue
            assert rules.ax(axis, dim) == jrules.ax(axis, dim), (axis, dim)


def test_one_card_seams():
    rules = sharding.make_rules(mesh.make_mesh((4, 2), ("data", "model")))
    x = torch.ones(3)
    assert rules.constrain(x, ("data",)) is x
    with pytest.raises(NotImplementedError, match="no one-card counterpart"):
        rules.sharding(("data", None))


def test_meshes_as_jax_names_them():
    single, multi = mesh.make_production_mesh(), mesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert multi.devices.shape == (2, 16, 16)
    assert mesh.make_host_mesh(4, 2).shape == {"data": 1, "model": 1}  # no card here
    with pytest.raises(ValueError, match="holds 8 devices"):
        mesh.LogicalMesh({"data": 4, "model": 2}, (0, 1))
