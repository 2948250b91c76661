"""K2 (``csrc/sweep_merge.cu``) on the card against its plain version, where
each row's bound drops candidates before the selection rounds: the one-launch
sweep at k = 20, 40 and 100 over levels of many narrow rows and of a few rows
256 and 1,024 neighbours wide, levels that force each plan of a few-row
level (a warp a row, one merge, a merge tree of depth 2 and 3), a sweep
whose every candidate ties at its row's bound, and the repair rounds' tile
form. The lists the kernel reads are rows as it writes them (distinct ids,
distances ascending, dead entries last), which the bound rests on.

These tests need a CUDA card (a CUDA kernel has no interpret mode) and skip
without one; on the card: ``python3 -m pytest -q -m card tests/``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import construct
from repro_torch.kernels import ops

pytestmark = pytest.mark.card

N = 60_000
# (rows, neighbour width) a level, in order: many narrow rows, few wide ones
SHAPE = ([(20_000, 0), (8_000, 8), (2_000, 16), (3, 16), (2, 256), (1, 1024), (4, 1024),
          (500, 40), (1, 256), (2, 1024), (3_000, 12)])
# levels that force each plan at k = 100: (3, 1024) in 171 parts a row (a
# tree of depth 3), (100, 256) in 10 or 20 parts (depth 2) on a grid of
# 1,056 or 2,112 warps, (178, 256) in 5 or 11, (1, 16) in 6 (one merge),
# (1,100, 64) a warp a row (2 * 1,100 > 2,112)
TREE_SHAPE = [(6_000, 0), (2_000, 8), (3, 1024), (100, 256), (178, 256), (1, 16), (1_100, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 has no interpret mode")
    return torch.device("cuda", 0)


def _levels(rng, shape, *, weights=10):
    """One (verts, nbr, w) a level: the first level's rows have no
    neighbour, the others draw theirs from every earlier level's rows (a
    tenth of the slots empty, each row's neighbours first), integer weights
    below ``weights``."""
    verts = rng.permutation(N).astype(np.int32)
    levels, at = [], 0
    for rows, width in shape:
        vs = verts[at : at + rows]
        nbr = rng.choice(verts[:at], size=(rows, width)).astype(np.int32) if at else np.full(
            (rows, width), -1, np.int32)
        nbr[rng.random(nbr.shape) < 0.1] = -1
        nbr = np.take_along_axis(nbr, np.argsort(nbr < 0, axis=1, kind="stable"), 1)
        w = np.where(nbr >= 0, rng.integers(0, weights, nbr.shape), np.inf).astype(np.float32)
        levels.append((vs, nbr, w))
        at += rows
    return levels


def _extras(rng, k, dev, *, dist=None):
    """(N+1, k) full lists as K2 writes them: distinct ids (from 4k, so
    lists share ids), distances ascending (integers below 20, or all
    ``dist``); the dummy row (-1, +inf)."""
    ids = np.argsort(rng.random((N + 1, 4 * k)), axis=1)[:, :k].astype(np.int32)
    d = np.sort(rng.integers(0, 20, (N + 1, k)), axis=1).astype(np.float32)
    if dist is not None:
        d[:] = dist
    ids[N], d[N] = -1, np.inf
    return torch.from_numpy(ids).to(dev), torch.from_numpy(d).to(dev)


def _sweep_both(plan, ex_ids, ex_d, k, dev):
    """The kernel's tables and tally, and the plain version's tables."""
    buckets = [(b.nbr, b.w, b.verts) for b in plan.buckets]
    got = [torch.full((N + 1, k), -1, dtype=torch.int32, device=dev),
           torch.full((N + 1, k), np.inf, dtype=torch.float32, device=dev)]
    want = [x.clone() for x in got]
    tally = ops.sweep_merge_levels(buckets, plan.levels, ex_ids, ex_d, *got, k)
    assert ops.sweep_merge_levels(buckets, plan.levels, ex_ids, ex_d, *want, k,
                                  use_kernel=False) is None
    torch.cuda.synchronize()
    return got, want, tally.tolist()


def _deep_rows(plan, k, e):
    """The rows the kernel merges by a tree of two or more levels, by its plan
    (``sweep_levels_kernel``): a level of R rows of width t, wider than one
    group of ``group_cap(k, E)`` neighbours, with 2R at most the grid's W
    warps, is spread in P = min(W // R, max(F, groups)) parts a row, cut to
    ceil(t / ceil(t / P)); its tree has fan-in F = 768 // k."""
    geometry = ops._fn("sweep_merge", "knn_sweep_geometry")
    warps = ops._fn("sweep_merge", "knn_sweep_levels_grid")(k) * geometry(0)
    cap = ops._fn("sweep_merge", "knn_sweep_group_cap")(k, e)
    fan = geometry(1) // k
    deep = 0
    for b, first, rows in plan.levels.tolist():
        t = plan.buckets[b].t_pad
        groups = -(-t // max(1, min(t, cap)))
        if fan < 2 or groups < 2 or 2 * rows > warps:
            continue
        spread = min(warps // max(1, rows), max(fan, groups))
        if -(-t // -(-t // spread)) > fan:
            deep += int((plan.buckets[b].verts[first : first + rows] != N).sum())
    return deep


def _slots_and_rows(levels):
    return (sum(int((nbr >= 0).sum()) for _, nbr, _ in levels),
            sum(len(vs) for vs, _, _ in levels))


@pytest.mark.parametrize("k", [20, 40, 100])
def test_sweep_levels_equal_the_plain_version(cuda, k):
    rng = np.random.default_rng(k)
    levels = _levels(rng, SHAPE)
    plan = construct.pack_sweep(N, "up", levels, device=cuda)
    ex_ids, ex_d = _extras(rng, k, cuda)
    got, want, (gathered, kept) = _sweep_both(plan, ex_ids, ex_d, k, cuda)
    differ = int(((got[0] != want[0]) | (got[1] != want[1])).any(dim=1).sum())
    assert differ == 0, f"{differ} rows differ from the plain version at k = {k}"
    assert bool((got[0][N] == -1).all()) and bool(torch.isinf(got[1][N]).all())
    slots, rows = _slots_and_rows(levels)
    assert gathered == k * slots + k * rows  # k a real neighbour slot, E = k a row
    assert 0 < kept < gathered


@pytest.mark.parametrize("k", [20, 100])
def test_sweep_levels_where_every_candidate_ties_at_the_bound(cuda, k):
    # every list at distance 5 and every weight 0: each row's bound is 5, and
    # its k entries are the k smallest of the ids it sees
    rng = np.random.default_rng(7 + k)
    levels = _levels(rng, SHAPE[:7], weights=1)
    plan = construct.pack_sweep(N, "up", levels, device=cuda)
    ex_ids, ex_d = _extras(rng, k, cuda, dist=5.0)
    got, want, (gathered, kept) = _sweep_both(plan, ex_ids, ex_d, k, cuda)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    written = torch.from_numpy(np.concatenate([vs for vs, _, _ in levels])).to(cuda).long()
    assert bool((got[1][written] == 5.0).all())
    slots, rows = _slots_and_rows(levels)
    # every candidate is live and at the bound; past a row's first selection
    # the running bound, its k-th key, drops the larger ids
    assert gathered == k * slots + k * rows and 0 < kept <= gathered


@pytest.mark.parametrize("ties", [False, True], ids=["spread", "ties"])
@pytest.mark.parametrize("k", [20, 40, 100])
def test_sweep_levels_merge_wide_rows_by_a_tree(cuda, k, ties):
    # with ties: every list at distance 5 and every weight 0, so each merge
    # of the tree keeps the k smallest ids it sees
    rng = np.random.default_rng(300 + k + ties)
    levels = _levels(rng, TREE_SHAPE, weights=1 if ties else 10)
    plan = construct.pack_sweep(N, "up", levels, device=cuda)
    ex_ids, ex_d = _extras(rng, k, cuda, dist=5.0 if ties else None)
    got, want, (gathered, kept) = _sweep_both(plan, ex_ids, ex_d, k, cuda)
    differ = int(((got[0] != want[0]) | (got[1] != want[1])).any(dim=1).sum())
    assert differ == 0, f"{differ} rows differ from the plain version at k = {k}"
    slots, rows = _slots_and_rows(levels)
    assert gathered == k * slots + k * rows and 0 < kept <= gathered
    # the shapes force the plans they are for: k = 20, no row takes more
    # parts than one merge holds; k = 100, the 1,024-wide rows take a tree on
    # any grid of at least 24 warps
    deep = _deep_rows(plan, k, k)
    assert deep == 0 if k == 20 else deep > 0


@pytest.mark.parametrize("k", [20, 40, 100])
@pytest.mark.parametrize("t_group", [None, 1, 3])
def test_sweep_merge_tile_equals_the_plain_version(cuda, k, t_group):
    # a repair round: the swept tables read and passed as their own extras,
    # rows of a few widths, neighbours that are targets too
    rng = np.random.default_rng(100 + k)
    levels = _levels(rng, SHAPE[:5])
    plan = construct.pack_sweep(N, "up", levels, device=cuda)
    ex_ids, ex_d = _extras(rng, k, cuda)
    (vk_ids, vk_d), _, _ = _sweep_both(plan, ex_ids, ex_d, k, cuda)
    for width, rows in ((4, 4_000), (64, 300), (700, 3)):
        verts = rng.choice(N, size=rows, replace=False).astype(np.int32)
        nbr = rng.choice(N, size=(rows, width)).astype(np.int32)
        nbr[rng.random(nbr.shape) < 0.15] = -1
        w = np.where(nbr >= 0, rng.integers(0, 10, nbr.shape), np.inf).astype(np.float32)
        args = [torch.from_numpy(x).to(cuda) for x in (nbr, verts, w)]
        args += [vk_ids, vk_d, vk_ids, vk_d]
        got = ops.sweep_merge(*args, k, t_group=t_group)
        want = ops.sweep_merge(*args, k, use_kernel=False)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (width, rows)
