"""Planted faults: a run drives the harness on the CPU with the timed path
broken underneath, and ``correct`` must come out false; the control (the
reference held in a lower precision) must fail the comparison too."""
from __future__ import annotations

import pytest
import torch

from knnbench.control import control_readings
from knnbench.tests.helpers import run_tiny, tiny_cell
from repro_torch.core import construct, engine
from repro_torch.kernels import ops


def _serve_half_batch(monkeypatch):
    real = ops.serve_gather

    def half(vk_ids, vk_d, queries, ks):
        ids, d = real(vk_ids, vk_d, queries, ks)
        ids[len(ids) // 2:], d[len(d) // 2:] = -1, float("inf")
        return ids, d
    monkeypatch.setattr(ops, "serve_gather", half)


def _serve_answer_altered(monkeypatch):
    real = ops.serve_gather

    def altered(vk_ids, vk_d, queries, ks):
        ids, d = real(vk_ids, vk_d, queries, ks)
        d[len(d) // 3, 0] += 1.0
        return ids, d
    monkeypatch.setattr(ops, "serve_gather", altered)


def _serve_state_unchanged(monkeypatch):
    real, first = ops.serve_gather, []

    def stale(vk_ids, vk_d, queries, ks):
        if not first:
            first.append(real(vk_ids, vk_d, queries, ks))
        return tuple(x.clone() for x in first[0])
    monkeypatch.setattr(ops, "serve_gather", stale)


def _serve_table_altered(monkeypatch):
    real = engine.build_knn_tables

    def altered(*args, **kwargs):
        ids, d = real(*args, **kwargs)
        d[17, 1] += 1.0
        return ids, d
    monkeypatch.setattr(engine, "build_knn_tables", altered)


def _build_state_unchanged(monkeypatch):
    real, first = construct.build_knn_tables, []

    def stale(*args, **kwargs):
        if not first:
            first.append(real(*args, **kwargs))
        return tuple(x.clone() for x in first[0])
    monkeypatch.setattr(construct, "build_knn_tables", stale)


def _build_half_levels(monkeypatch):
    real = ops.sweep_merge_levels

    def half(buckets, levels, *args, **kwargs):
        return real(buckets, levels[: max(1, len(levels) // 2)], *args, **kwargs)
    monkeypatch.setattr(ops, "sweep_merge_levels", half)


def _build_answer_altered(monkeypatch):
    real = ops.sweep_merge_levels

    def altered(buckets, levels, ex_ids, ex_d, ids, d, k, **kwargs):
        out = real(buckets, levels, ex_ids, ex_d, ids, d, k, **kwargs)
        ids[23, 0] = ids[23, 1]
        return out
    monkeypatch.setattr(ops, "sweep_merge_levels", altered)


FAULTS = {
    "k20-serve": [_serve_half_batch, _serve_answer_altered, _serve_state_unchanged,
                  _serve_table_altered],
    "k20-build": [_build_state_unchanged, _build_half_levels, _build_answer_altered],
}


@pytest.mark.parametrize("name,plant", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: x if isinstance(x, str) else x.__name__.lstrip("_"))
def test_a_planted_fault_makes_the_run_incorrect(name, plant, monkeypatch, tmp_path):
    cell = tiny_cell(name)
    intact, checks = run_tiny(cell, tmp_path)
    assert intact["correct"] and all(v == 0 for v, _ in checks.values())
    plant(monkeypatch)
    broken, checks = run_tiny(cell, tmp_path)
    assert not broken["correct"]
    assert any(v > lim for v, lim in checks.values())


@pytest.mark.parametrize("name", ["k20-serve", "k100-build"])
def test_the_control_fails_and_the_exact_reference_is_the_program(name, tmp_path):
    # 40 x 40 at 2% objects: k = 8 distances reach past 16, where fp8's 4
    # significant bits round, and stay under 256, where bfloat16's 8 do not
    cell = tiny_cell(name, grid=40, k=8, mu=0.02)
    low = control_readings(cell, 2**35 + 1, torch.device("cpu"), bits=4, exact=True,
                           cache_dir=tmp_path)
    assert low["exact_equal"]
    assert all(low[key] > 0 for key in low["limits"])
    high = control_readings(cell, 2**35 + 1, torch.device("cpu"), bits=8)
    assert all(high[key] == 0 for key in high["limits"])
