"""The port's three kernel functions (plain PyTorch versions, on the CPU) held
against the JAX package: its pure-jnp oracles (``repro.kernels.ref``) and its
Pallas kernels in interpret mode (``repro.kernels.ops`` with use_pallas=True).

Inputs are made with numpy from a seed and fed to both sides. Tolerance:
exact (``array_equal`` on int32 ids and on float32 distances). The functions
add one float32 weight to one float32 distance and take mins, so there is no
summation order to differ in, and ties go to the smaller id on both sides.
The CUDA kernels themselves cannot run without a GPU; ``chip_smoke.py`` holds
them against these same plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import _frontier_round as jax_frontier_round
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sweep_merge import kround_merge as jax_kround_merge
from repro_torch.kernels import ops, ref


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _eq(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w))


# ---------------------------------------------------------------------------
# topk_merge
# ---------------------------------------------------------------------------


def _topk_case(b, c, dtype, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, max(4, c // 3), size=(b, c)).astype(np.int32)
    ids[rng.random((b, c)) < 0.15] = -1
    d = np.round(rng.uniform(0, 64, size=(b, c)), 1).astype(dtype)
    return ids, d


@pytest.mark.parametrize("b", [1, 7, 128, 300])
@pytest.mark.parametrize("c,k", [(16, 3), (130, 10), (257, 20)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_topk_merge_matches_jax_ref(b, c, k, dtype):
    ids, d = _topk_case(b, c, dtype, b * 1000 + c)
    got = ops.topk_merge(*_t(ids, d), k)
    assert got[0].dtype == torch.int32 and got[1].dtype == _t(d)[0].dtype
    _eq(got, jref.topk_merge_ref(*_j(ids, d), k))
    _eq(ref.topk_merge_ref(*_t(ids, d), k), got)


@pytest.mark.parametrize("b,c,k", [(7, 16, 3), (128, 130, 10), (9, 257, 20)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_topk_merge_matches_pallas_interpret(b, c, k, dtype):
    ids, d = _topk_case(b, c, dtype, b + c)
    _eq(ops.topk_merge(*_t(ids, d), k), jops.topk_merge(*_j(ids, d), k, use_pallas=True))


def test_topk_merge_duplicate_ids_keep_smaller_distance():
    c = 130
    ids = np.full((4, c), -1, np.int32)
    d = np.full((4, c), np.inf, np.float32)
    ids[:, 127], d[:, 127] = 7, 5.0
    ids[:, 128], d[:, 128] = 7, 3.0
    ids[:, 0], d[:, 0] = 1, 4.0
    got_i, got_d = ops.topk_merge(*_t(ids, d), 3)
    _eq((got_i, got_d), jref.topk_merge_ref(*_j(ids, d), 3))
    np.testing.assert_array_equal(got_i.numpy()[0], [7, 1, -1])
    np.testing.assert_array_equal(got_d.numpy()[0, :2], [3.0, 4.0])


def test_topk_merge_all_invalid_rows():
    ids = np.full((8, 37), -1, np.int32)
    d = np.zeros((8, 37), np.float32)  # distances must be ignored
    got_i, got_d = ops.topk_merge(*_t(ids, d), 4)
    assert (got_i.numpy() == -1).all() and np.isinf(got_d.numpy()).all()
    _eq((got_i, got_d), jops.topk_merge(*_j(ids, d), 4, use_pallas=True))


def test_topk_merge_k_exceeds_distinct_candidates():
    ids = np.array([[3, 3, 5, 5, 3]], np.int32)
    d = np.array([[2.0, 1.0, 9.0, 8.0, 4.0]], np.float32)
    got_i, got_d = ops.topk_merge(*_t(ids, d), 6)  # also C < k
    np.testing.assert_array_equal(got_i.numpy()[0], [3, 5, -1, -1, -1, -1])
    np.testing.assert_array_equal(got_d.numpy()[0, :2], [1.0, 8.0])
    assert np.isinf(got_d.numpy()[0, 2:]).all()
    _eq((got_i, got_d), jref.topk_merge_ref(*_j(ids, d), 6))


def test_topk_merge_distance_ties_pick_smaller_id():
    ids = np.array([[9, 2, 5, 2, 9]], np.int32)
    d = np.array([[1.0, 1.0, 1.0, 7.0, 7.0]], np.float32)
    got_i, got_d = ops.topk_merge(*_t(ids, d), 3)
    np.testing.assert_array_equal(got_i.numpy()[0], [2, 5, 9])
    np.testing.assert_array_equal(got_d.numpy()[0], [1.0, 1.0, 1.0])
    _eq((got_i, got_d), jref.topk_merge_ref(*_j(ids, d), 3))


@pytest.mark.parametrize("c", [1, 5, 127, 129, 200, 257])
def test_topk_merge_odd_widths(c):
    rng = np.random.default_rng(c)
    ids = rng.integers(-1, 30, size=(6, c)).astype(np.int32)
    d = np.round(rng.uniform(0, 9, size=(6, c)), 1).astype(np.float32)
    got = ops.topk_merge(*_t(ids, d), 5)
    _eq(got, jref.topk_merge_ref(*_j(ids, d), 5))
    _eq(got, jops.topk_merge(*_j(ids, d), 5, use_pallas=True))


# K1's plan: the registers a lane and the group of candidates the wrapper picks
# for a C-wide row, and the group walk it implies, mirrored in numpy


def _np_kround(ids, d, k):
    """numpy ``kround_merge``: k rounds of min distance, ties to the smaller
    id, then every candidate of the selected id dropped."""
    d = np.where(ids < 0, np.inf, d).astype(np.float32)
    out_i = np.full((ids.shape[0], k), -1, np.int32)
    out_d = np.full((ids.shape[0], k), np.inf, np.float32)
    for r in range(k if ids.shape[1] else 0):
        dmin = d.min(axis=1)
        idmin = np.where(d == dmin[:, None], ids, np.iinfo(np.int32).max).min(axis=1)
        ok = np.isfinite(dmin)
        out_i[:, r] = np.where(ok, idmin, -1)
        out_d[:, r] = np.where(ok, dmin, np.inf)
        d = np.where(ids == idmin[:, None], np.inf, d)
    return out_i, out_d


def _np_topk_groups(ids, d, k):
    """K1's walk of a row: groups of ``topk_plan``'s width, each merged with
    the k best of the groups before, every group within the warp's keys."""
    c = ids.shape[1]
    regs, group = ops.topk_plan(c, k)
    run = None
    for g0 in range(0, max(c, 1), group):
        g_ids, g_d = ids[:, g0 : g0 + group], d[:, g0 : g0 + group]
        if run is not None:
            g_ids, g_d = np.concatenate([g_ids, run[0]], 1), np.concatenate([g_d, run[1]], 1)
        assert g_ids.shape[1] <= 32 * regs
        run = _np_kround(g_ids, g_d, k)
    return run


@pytest.mark.parametrize("c,k", [(7, 20), (128, 20), (129, 20), (256, 20), (257, 20), (512, 20),
                                 (513, 20), (768, 20), (769, 20), (769, 3), (1600, 20)])
def test_topk_merge_plan_in_groups_matches_jax_kround_merge(c, k):
    regs, group = ops.topk_plan(c, k)
    if c <= ops.TOPK_CANDS:  # one group on the fewest registers that hold it
        assert group == c and 32 * regs >= c and (regs == 4 or 32 * regs // 2 < c)
    else:
        assert regs == 24 and group + k == ops.TOPK_CANDS
    rng = np.random.default_rng(c * 31 + k)
    ids = rng.integers(0, max(8, c // 4), size=(6, c)).astype(np.int32)  # ties and repeats
    ids[rng.random((6, c)) < 0.15] = -1
    ids[0] = -1                                                          # an all-invalid row
    d = rng.integers(0, 24, size=(6, c)).astype(np.float32)
    got = _np_topk_groups(ids, d, k)
    _eq(got, jref.topk_merge_ref(*_j(ids, d), k))
    _eq(got, jax_kround_merge(jnp.asarray(ids), jnp.asarray(np.where(ids < 0, np.inf, d)), k))
    _eq(ops.topk_merge(*_t(ids, d), k), got)


def test_topk_plan_refuses_what_the_kernel_cannot_hold():
    for k in (0, ops.TOPK_MAX_K + 1):
        with pytest.raises(ValueError, match="k="):
            ops.topk_plan(100, k)
    assert ops.topk_plan(30000, 20) == (24, ops.TOPK_CANDS - 20)  # any C: no shared memory


# ---------------------------------------------------------------------------
# sweep_merge
# ---------------------------------------------------------------------------


def _sweep_case(rng, *, n, chunk, t, k, e=None, pad_rows=0):
    e = k if e is None else e
    nbr = rng.integers(-1, n, size=(chunk, t)).astype(np.int32)
    verts = rng.choice(n, size=chunk, replace=False).astype(np.int32)
    nbr[np.isin(nbr, verts)] = -1  # level invariant: targets are never sources
    if pad_rows:                   # padded rows aim at the dummy row
        verts[-pad_rows:] = n
        nbr[-pad_rows:] = -1
    w = rng.uniform(0, 10, (chunk, t)).astype(np.float32)
    w[nbr < 0] = np.inf
    ex_ids = rng.integers(-1, n, size=(n + 1, e)).astype(np.int32)
    ex_d = rng.uniform(0, 50, (n + 1, e)).astype(np.float32)
    ex_d[ex_ids < 0] = np.inf
    ex_ids[n], ex_d[n] = -1, np.inf
    vk_ids = rng.integers(-1, n, size=(n + 1, k)).astype(np.int32)
    vk_d = np.sort(rng.uniform(0, 50, (n + 1, k)), axis=1).astype(np.float32)
    vk_d[vk_ids < 0] = np.inf
    vk_ids[n], vk_d[n] = -1, np.inf
    return nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d


def _sweep_both_forms(case, k):
    """The port's in-place result (full tables: the rows as one level of
    ``sweep_merge_levels``) and its tile result (``sweep_merge``)."""
    args = _t(*case)
    tile = ops.sweep_merge(*args, k)
    np.testing.assert_array_equal(args[5].numpy(), case[5])  # tables only read
    np.testing.assert_array_equal(args[6].numpy(), case[6])
    nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d = _t(*case)
    one_level = torch.tensor([[0, 0, verts.shape[0]]], dtype=torch.int32)
    ops.sweep_merge_levels([(nbr, w, verts)], one_level, ex_ids, ex_d, vk_ids, vk_d, k)
    return (vk_ids, vk_d), tile


@pytest.mark.parametrize("chunk,t,k,pad_rows", [
    (4, 1, 2, 0), (8, 3, 5, 0), (8, 7, 20, 0), (4, 4, 3, 0), (8, 5, 7, 3),
])
def test_sweep_merge_matches_jax_ref(chunk, t, k, pad_rows):
    rng = np.random.default_rng(chunk * 100 + t * 10 + k)
    case = _sweep_case(rng, n=37, chunk=chunk, t=t, k=k, pad_rows=pad_rows)
    full, tile = _sweep_both_forms(case, k)
    want = jref.sweep_merge_ref(*_j(*case), k)
    _eq(full, want)
    verts = case[1]
    _eq(tile, (np.asarray(want[0])[verts], np.asarray(want[1])[verts]))
    _eq(full, jops.sweep_merge(*_j(*case), k, use_pallas=False))


@pytest.mark.parametrize("chunk,t,k", [(4, 1, 2), (8, 3, 5), (4, 4, 3), (8, 5, 7)])
def test_sweep_merge_matches_pallas_interpret(chunk, t, k):
    rng = np.random.default_rng(chunk * 100 + t * 10 + k)
    case = _sweep_case(rng, n=41, chunk=chunk, t=t, k=k)
    full, _ = _sweep_both_forms(case, k)
    _eq(full, jops.sweep_merge(*_j(*case), k, use_pallas=True))


def test_sweep_merge_untouched_rows_and_dummy_row_preserved():
    rng = np.random.default_rng(0)
    case = _sweep_case(rng, n=29, chunk=6, t=3, k=4, pad_rows=2)
    (got_i, got_d), _ = _sweep_both_forms(case, 4)
    untouched = np.setdiff1d(np.arange(30), case[1][:-2])
    np.testing.assert_array_equal(got_i.numpy()[untouched], case[5][untouched])
    np.testing.assert_array_equal(got_d.numpy()[untouched], case[6][untouched])
    assert (got_i.numpy()[29] == -1).all() and np.isinf(got_d.numpy()[29]).all()


def test_sweep_merge_all_invalid_neighbors_keeps_extras_only():
    n, chunk, t, k = 12, 4, 2, 3
    nbr = np.full((chunk, t), -1, np.int32)
    verts = np.arange(chunk, dtype=np.int32)
    w = np.full((chunk, t), np.inf, np.float32)
    ex_ids = np.full((n + 1, k), -1, np.int32)
    ex_d = np.full((n + 1, k), np.inf, np.float32)
    ex_ids[:chunk, 0] = np.arange(chunk) + 5
    ex_d[:chunk, 0] = 2.5
    vk_ids = np.full((n + 1, k), -1, np.int32)
    vk_d = np.full((n + 1, k), np.inf, np.float32)
    case = (nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d)
    (got_i, got_d), _ = _sweep_both_forms(case, k)
    np.testing.assert_array_equal(got_i.numpy()[:chunk, 0], np.arange(chunk) + 5)
    np.testing.assert_array_equal(got_d.numpy()[:chunk, 0], np.float32(2.5))
    assert (got_i.numpy()[:chunk, 1:] == -1).all()
    _eq((got_i, got_d), jops.sweep_merge(*_j(*case), k, use_pallas=True))


def test_sweep_merge_ties_and_dedup_across_neighbors():
    """Two neighbours both know object 3 at the same shifted distance; the
    merged row keeps one copy and breaks equal distances by id."""
    n, chunk, t, k = 10, 4, 2, 3
    nbr = np.array([[0, 1]] * chunk, np.int32)
    verts = np.arange(4, 8).astype(np.int32)
    w = np.ones((chunk, t), np.float32)
    vk_ids = np.full((n + 1, k), -1, np.int32)
    vk_d = np.full((n + 1, k), np.inf, np.float32)
    vk_ids[0, :2], vk_d[0, :2] = [3, 8], [1.0, 1.0]
    vk_ids[1, :2], vk_d[1, :2] = [3, 2], [1.0, 1.0]
    ex_ids = np.full((n + 1, k), -1, np.int32)
    ex_d = np.full((n + 1, k), np.inf, np.float32)
    case = (nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d)
    (got_i, got_d), _ = _sweep_both_forms(case, k)
    _eq((got_i, got_d), jref.sweep_merge_ref(*_j(*case), k))
    np.testing.assert_array_equal(got_i.numpy()[4], [2, 3, 8])
    np.testing.assert_array_equal(got_d.numpy()[4], [2.0, 2.0, 2.0])


def test_sweep_merge_tile_form_reads_pre_round_rows():
    """Rows that read each other (a repair round): the tile form gives every
    row the pre-round view, like the JAX engine's functional merge."""
    rng = np.random.default_rng(5)
    n, k = 20, 4
    case = list(_sweep_case(rng, n=n, chunk=6, t=3, k=k))
    verts = case[1]
    case[0] = rng.choice(verts, size=(6, 3)).astype(np.int32)  # neighbours ARE targets
    case[2] = rng.uniform(1, 5, (6, 3)).astype(np.float32)
    case[3], case[4] = case[5], case[6]                        # extras = live tables
    tile = ops.sweep_merge(*_t(*case), k)
    want = jops.sweep_merge(*_j(*case), k, use_pallas=False)
    _eq(tile, (np.asarray(want[0])[verts], np.asarray(want[1])[verts]))


def _merge_in_groups(case, k, t_group, parts=1):
    """K2's selection, in plain torch: neighbours walked in groups of
    ``t_group``; part p (a warp of ``csrc/sweep_merge.cu``) takes groups p,
    p + parts, ..., each merged (``kround_merge``) together with the row's
    extras (part 0's first group) or the part's running k best (its later
    groups); then the parts' k-lists are merged once more, as warp 0 of a
    block does for a wide row of the one-launch sweep (parts = 8)."""
    nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d = _t(*case)
    e = ex_ids.shape[1]
    n_groups = max(1, -(-nbr.shape[1] // t_group))
    out = []
    for p in range(min(parts, n_groups)):
        run = None
        for g in range(p, n_groups, parts):
            j = slice(g * t_group, (g + 1) * t_group)
            c_ids, c_d = ref.sweep_candidates(nbr[:, j], verts, w[:, j], ex_ids, ex_d,
                                              vk_ids, vk_d)
            c_ids, c_d = c_ids[:, : c_ids.shape[1] - e], c_d[:, : c_d.shape[1] - e]
            if run is not None:
                c_ids, c_d = torch.cat([c_ids, run[0]], 1), torch.cat([c_d, run[1]], 1)
            elif p == 0:
                rows = verts.long()
                c_ids = torch.cat([c_ids, ex_ids[rows]], 1)
                c_d = torch.cat([c_d, torch.where(ex_ids[rows] < 0, np.inf, ex_d[rows])], 1)
            run = ref.kround_merge(c_ids, c_d, k)
        out.append(run)
    if len(out) == 1:
        return out[0]
    return ref.kround_merge(torch.cat([o[0] for o in out], 1), torch.cat([o[1] for o in out], 1), k)


def _tie_case(seed, *, n=60, chunk=24, t=7, k=6):
    """Ties everywhere: ids from a range of 12, integer distances 0-4, integer
    weights 0-2, each table row sorted by distance as construction leaves it;
    and row 0's first neighbour carries the rounding tie: distances 1e-8 <
    2e-8 (ids 9, then 3) both become 1.0 after + w = 1.0, so the later entry
    wins the tie by its smaller id (row 0 has no other neighbour or extra)."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(-1, n // 2, size=(chunk, t)).astype(np.int32)
    verts = rng.choice(np.arange(n // 2, n), size=chunk, replace=False).astype(np.int32)
    w = rng.integers(0, 3, size=(chunk, t)).astype(np.float32)
    w[nbr < 0] = np.inf
    ex_ids = rng.integers(-1, 12, size=(n + 1, k)).astype(np.int32)
    ex_d = rng.integers(0, 5, size=(n + 1, k)).astype(np.float32)
    vk_ids = rng.integers(-1, 12, size=(n + 1, k)).astype(np.int32)
    vk_d = np.sort(rng.integers(0, 5, size=(n + 1, k)), axis=1).astype(np.float32)
    nbr[0], w[0] = -1, np.inf
    nbr[0, 0], w[0, 0] = 1, 1.0
    vk_ids[1, :2], vk_d[1, :2] = [9, 3], [1e-8, 2e-8]
    vk_ids[1, 2:][np.isin(vk_ids[1, 2:], [3, 9])] = -1
    vk_d[1, 2:] = np.maximum(vk_d[1, 2:], 2)
    ex_ids[verts[0]] = -1
    for x_ids, x_d in ((ex_ids, ex_d), (vk_ids, vk_d)):
        x_d[x_ids < 0] = np.inf
        x_ids[n], x_d[n] = -1, np.inf
    return nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("t_group,parts", [(1, 1), (2, 1), (3, 1), (7, 1), (1, 8), (2, 3)])
def test_sweep_selection_in_groups_matches_jax_kround_merge(seed, t_group, parts):
    case = _tie_case(seed)
    k = case[5].shape[1]
    got = _merge_in_groups(case, k, t_group, parts)
    want = tuple(np.asarray(x)[case[1]] for x in jref.sweep_merge_ref(*_j(*case), k))
    _eq(got, want)
    c_ids, c_d = ref.sweep_candidates(*_t(*case))
    _eq(got, jax_kround_merge(jnp.asarray(c_ids.numpy()), jnp.asarray(c_d.numpy()), k))
    _eq(ops.sweep_merge(*_t(*case), k, t_group=t_group), want)


def test_sweep_selection_rounding_tie_goes_to_the_smaller_id():
    case = _tie_case(3)
    assert np.float32(1.0) + np.float32(1e-8) == np.float32(1.0) + np.float32(2e-8)
    got_i, got_d = _merge_in_groups(case, 6, 1, parts=8)
    want = jref.sweep_merge_ref(*_j(*case), 6)
    _eq((got_i, got_d), tuple(np.asarray(x)[case[1]] for x in want))
    np.testing.assert_array_equal(got_i.numpy()[0, :2], [3, 9])
    np.testing.assert_array_equal(got_d.numpy()[0, :2], [1.0, 1.0])



def _merge_by_tree(case, k, parts, fan):
    """A spread row of K2's one-launch sweep (``sweep_levels_kernel``), in
    plain torch: the neighbour slots cut into ``parts`` parts of ceil(t /
    parts) slots, each part's dedup top-k (``kround_merge``; part 0's with
    the row's extras), then the parts' lists merged in groups of ``fan``,
    level by level, until one is left, as the last arriver at each node of
    the kernel's tree merges them. Returns the rows, the tree's depth and
    the parts' lists."""
    nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d = _t(*case)
    e, t = ex_ids.shape[1], nbr.shape[1]
    t_part = -(-t // parts)
    assert -(-t // t_part) == parts
    lists = []
    for g in range(parts):
        j = slice(g * t_part, (g + 1) * t_part)
        c_ids, c_d = ref.sweep_candidates(nbr[:, j], verts, w[:, j], ex_ids, ex_d, vk_ids, vk_d)
        if g:  # the extras are part 0's alone
            c_ids, c_d = c_ids[:, :-e], c_d[:, :-e]
        lists.append(ref.kround_merge(c_ids, c_d, k))
    leaves, depth = lists, 0
    while len(lists) > 1:
        lists = [ref.kround_merge(torch.cat([x[0] for x in lists[a : a + fan]], 1),
                                  torch.cat([x[1] for x in lists[a : a + fan]], 1), k)
                 for a in range(0, len(lists), fan)]
        depth += 1
    return lists[0], depth, leaves


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("parts,fan,t,depth", [(3, 7, 7, 1), (8, 2, 16, 3), (43, 7, 86, 2),
                                               (171, 7, 171, 3), (38, 38, 76, 1)])
def test_sweep_merge_tree_matches_jax_kround_merge(seed, parts, fan, t, depth):
    # the tie case over t slots, its last third empty as a bucket's padding
    # (so the last parts are all dead), and row 1 meeting row 0's rounding
    # tie (ids 9, 3 both at 1.0) in a later part than its first
    case = _tie_case(seed, t=t)
    nbr, w = case[0], case[2]
    live = t - t // 3
    nbr[:, live:] = -1
    nbr[1, live // 2] = 1
    w[1, live // 2] = 1.0
    w[nbr < 0] = np.inf
    k = case[5].shape[1]
    got, levels, leaves = _merge_by_tree(case, k, parts, fan)
    assert levels == depth
    want = tuple(np.asarray(x)[case[1]] for x in jref.sweep_merge_ref(*_j(*case), k))
    _eq(got, want)
    c_ids, c_d = ref.sweep_candidates(*_t(*case))
    _eq(got, jax_kround_merge(jnp.asarray(c_ids.numpy()), jnp.asarray(c_d.numpy()), k))
    # row 0's rounding tie goes to the smaller id through every merge level
    np.testing.assert_array_equal(got[0].numpy()[0, :2], [3, 9])
    np.testing.assert_array_equal(got[1].numpy()[0, :2], [1.0, 1.0])
    # the tree merged parts short of k live entries, and all-dead parts
    live_entries = torch.stack([(ids >= 0).sum(1) for ids, _ in leaves])
    assert bool(((live_entries > 0) & (live_entries < k)).any())
    assert int(live_entries[-1].sum()) == 0


# K2's pruned walk (csrc/sweep_merge.cu), mirrored in numpy on packed keys:
# a bound from the row's full source lists before any round, each candidate
# above it dropped as it is gathered, the survivors selected a buffer at a
# time with the running k best carried on, whose k-th then tightens the bound


_INF_BITS = 0x7F800000
_DEAD = (_INF_BITS << 32) | 0xFFFFFFFF


def _keys(ids, d) -> list[int]:
    """kround.cuh's ``pack_key``: (float32 bits << 32) | id, and the dead key
    for an id < 0 or a distance that is +inf, NaN or negative (-0.0 is 0)."""
    bits = (np.asarray(d, np.float32) + np.float32(0)).view(np.uint32).astype(np.int64)
    ids = np.asarray(ids, np.int64)
    return [_DEAD if i < 0 or b >= _INF_BITS else (b << 32) | i
            for i, b in zip(ids.ravel().tolist(), bits.ravel().tolist())]


def _dedup_top(keys, k) -> list[int]:
    """``select_rounds``: the k least keys of distinct ids, then dead keys."""
    best: dict[int, int] = {}
    for key in keys:
        if key < _DEAD:
            best[key & 0xFFFFFFFF] = min(best.get(key & 0xFFFFFFFF, key), key)
    top = sorted(best.values())[:k]
    return top + [_DEAD] * (k - len(top))


def _row_bound(nbr_i, w_i, v, case, k, by_key=False) -> int:
    """``row_bound``: the least k-th distance, + w, of the full lists of the
    slots given and of the row's extras (the k-th live as stored, w >= 0), as
    the largest key at it (``by_key``: the k-th's own key, which a rounding
    tie inside one list breaks)."""
    _, _, _, ex_ids, ex_d, vk_ids, vk_d = case
    kths = [_keys([vk_ids[u, k - 1]], [np.float32(wj) + vk_d[u, k - 1]])[0]
            for u, wj in zip(nbr_i, w_i) if u >= 0 and wj >= 0 and vk_d[u, k - 1] >= 0]
    if ex_ids.shape[1] >= k:
        kths += _keys([ex_ids[v, k - 1]], [ex_d[v, k - 1]])
    least = min(kths, default=_DEAD)
    if least == _DEAD:
        return _DEAD - 1
    return least if by_key else least | 0xFFFFFFFF


class _Walk:
    """``Walk``: candidates come 32 at a time (a warp's lanes, in order),
    judged against the bound as the batch arrives; the kept ones fill a
    buffer of ``limit`` keys, selected whenever it is full and once more at
    the end if it gained keys since."""

    def __init__(self, lim, k, limit):
        self.lim, self.k, self.limit = lim, k, limit
        self.buf, self.sel, self.fresh = [], None, True
        self.gathered = self.kept = 0

    def select(self):
        self.sel = _dedup_top(self.buf, self.k)
        self.lim = min(self.lim, self.sel[-1])
        self.buf = [key for key in self.sel if key < _DEAD]
        self.fresh = False

    def offer(self, batch):
        kept = [key for key, _ in batch if key <= self.lim]
        self.gathered += sum(real for _, real in batch)
        self.kept += len(kept)
        for key in kept:
            if len(self.buf) == self.limit:
                self.select()
            self.buf.append(key)
            self.fresh = True

    def finish(self):
        if self.fresh:
            self.select()
        return self.sel


def _walk_part(case, i, k, j0, j1, extras, lim, limit) -> _Walk:
    """``merge_part``: the row's extras (when ``extras``), then the entries of
    neighbour slots [j0, j1) in gather order, 32 a batch."""
    nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d = case
    v, walk = verts[i], _Walk(lim, k, limit)
    stream = [(key, True) for key in _keys(ex_ids[v], ex_d[v])] if extras else []
    for j in range(j0, j1):
        u = nbr[i, j]
        stream += ([(key, True) for key in _keys(vk_ids[u], np.float32(w[i, j]) + vk_d[u])]
                   if u >= 0 else [(_DEAD, False)] * k)
    n_ex = ex_ids.shape[1] if extras else 0
    for at in (range(0, n_ex, 32), range(n_ex, len(stream), 32)):
        for x in at:
            walk.offer(stream[x : min(x + 32, at.stop)])
    walk.finish()
    return walk


def _merge_pruned(case, k, *, limit=768, t_part=None, by_key=False):
    """K2's rows as the kernel walks them: one part of the whole row, or
    parts of ``t_part`` neighbour slots, each bounded by its own slots' lists
    and the row's extras, then the parts' k best merged. Returns (ids, d)
    and the walks."""
    nbr, verts, w = case[:3]
    t = nbr.shape[1]
    step = max(1, t if t_part is None else t_part)
    out, walks = [], []
    for i in range(nbr.shape[0]):
        parts = []
        for j0 in range(0, max(t, 1), step):
            j1 = min(t, j0 + step)
            lim = _row_bound(nbr[i, j0:j1], w[i, j0:j1], verts[i], case, k, by_key)
            parts.append(_walk_part(case, i, k, j0, j1, j0 == 0, lim, limit))
        walks += parts
        out.append(_dedup_top([key for p in parts for key in p.sel], k))
    keys = np.array(out, np.int64).reshape(len(out), k)
    dead = keys == _DEAD
    ids = np.where(dead, -1, keys & 0xFFFFFFFF).astype(np.int32)
    bits = (keys >> 32).astype(np.uint32)
    d = np.where(dead, np.inf, bits.view(np.float32)).astype(np.float32)
    return (ids, d), walks


def _selected_whole(case, k):
    """The full selection under the kernel's key semantics: every candidate of
    the row, the dead ones (+inf, NaN, negative) made (-1, +inf), merged by
    ``kround_merge`` with nothing dropped first."""
    c_ids, c_d = ref.sweep_candidates(*_t(*case))
    dead = torch.from_numpy(
        np.array(_keys(c_ids.numpy(), c_d.numpy())).reshape(c_ids.shape) == _DEAD)
    c_ids[dead] = -1
    c_d[dead] = np.inf
    return ref.kround_merge(c_ids, c_d, k)


def _table_rows(rng, rows, cols, *, full, dists=12, tail=None):
    """(rows, cols) lists as K2 writes them: distinct ids (from a range of
    2 * cols, so lists share ids), distances ascending (integers below
    ``dists``: ties abound), dead entries last; a share ``full`` of the rows
    has every entry live. ``tail`` puts ids at that distance in the dead
    slots in place of (-1, +inf)."""
    ids = np.argsort(rng.random((rows, 2 * cols)), axis=1)[:, :cols].astype(np.int32)
    d = np.sort(rng.integers(0, dists, (rows, cols)), axis=1).astype(np.float32)
    live = np.where(rng.random(rows) < full, cols, rng.integers(0, cols, rows))
    dead = np.arange(cols)[None, :] >= live[:, None]
    if tail is None:
        ids[dead] = -1
    d[dead] = np.inf if tail is None else tail
    return ids, d


def _pruned_case(seed, *, n=40, chunk=6, t=9, k=5, e=None, full=0.8, dists=12, weights=4):
    """A sweep step over lists as K2 writes them: about one neighbour slot in
    n empty, targets never sources, integer weights below ``weights``."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(-1, n, size=(chunk, t)).astype(np.int32)
    verts = rng.choice(n, size=chunk, replace=False).astype(np.int32)
    nbr[np.isin(nbr, verts)] = -1
    w = rng.integers(0, weights, (chunk, t)).astype(np.float32)
    w[nbr < 0] = np.inf
    ex_ids, ex_d = _table_rows(rng, n + 1, k if e is None else e, full=full, dists=dists)
    vk_ids, vk_d = _table_rows(rng, n + 1, k, full=full, dists=dists)
    for x_ids, x_d in ((ex_ids, ex_d), (vk_ids, vk_d)):
        x_ids[n], x_d[n] = -1, np.inf
    return nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d


def _rounding_tie_case():
    """One row, one neighbour, whose list 9, 3, 4, 6 at 1e-8 < 2e-8 < 3e-8 <
    4e-8 lies at 1.0 throughout after + w = 1.0: its k-th key (1.0, id 6)
    lies below the key (1.0, id 9) that the row selects."""
    n, k = 8, 4
    nbr, verts = np.array([[1, -1]], np.int32), np.array([0], np.int32)
    w = np.array([[1.0, np.inf]], np.float32)
    vk_ids = np.full((n + 1, k), -1, np.int32)
    vk_d = np.full((n + 1, k), np.inf, np.float32)
    vk_ids[1], vk_d[1] = [9, 3, 4, 6], [1e-8, 2e-8, 3e-8, 4e-8]
    ex_ids, ex_d = np.full((n + 1, 1), -1, np.int32), np.full((n + 1, 1), np.inf, np.float32)
    return nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d


def _poisoned_tail_case(seed):
    """Dead entries that are not (-1, +inf): lists whose tails hold ids at
    NaN, -1.0 or +inf, and weights below 0 or NaN on real slots (a list so
    shifted gives no bound, and its negative sums are dead)."""
    rng = np.random.default_rng(seed)
    nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d = _pruned_case(seed, t=12, full=0.5)
    n = vk_ids.shape[0] - 1
    for x_ids, x_d in ((ex_ids, ex_d), (vk_ids, vk_d)):
        for tail in (np.nan, -1.0, np.inf):
            rows = rng.random(n) < 0.34
            t_ids, t_d = _table_rows(rng, int(rows.sum()), x_ids.shape[1], full=0.3, tail=tail)
            x_ids[:n][rows], x_d[:n][rows] = t_ids, t_d
    odd = (rng.random(w.shape) < 0.2) & (nbr >= 0)
    w[odd] = rng.choice(np.array([-1.0, -2.5, np.nan], np.float32), size=int(odd.sum()))
    return nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d


def _extras_only_case():
    nbr, verts, w, *rest = _pruned_case(9, full=0.9)
    return (np.full_like(nbr, -1), verts, np.full_like(w, np.inf), *rest)


# name -> (case, k, walk options); the random cases' lists are as K2 writes them
_PRUNED = {
    "one_buffer": (lambda: _pruned_case(0), 5, {}),
    "small_buffers": (lambda: _pruned_case(1, t=40), 5, {"limit": 15}),
    "k20_buffers": (lambda: _pruned_case(2, t=12, k=20, n=60), 20, {"limit": 45}),
    "parts": (lambda: _pruned_case(3, t=40), 5, {"t_part": 7}),
    "parts_small_buffers": (lambda: _pruned_case(4, t=40), 5, {"t_part": 9, "limit": 12}),
    "extras_shorter_than_k": (lambda: _pruned_case(5, e=2), 5, {"limit": 15}),
    "extras_longer_than_k": (lambda: _pruned_case(6, k=3, e=8), 3, {}),
    "ties_at_theta": (lambda: _pruned_case(7, t=20, dists=2, weights=1), 5, {"limit": 12}),
    "rounding_tie": (_rounding_tie_case, 4, {}),
    "lists_short_of_k": (lambda: _pruned_case(8, t=20, full=0.0), 5, {"limit": 15}),
    "extras_only": (_extras_only_case, 5, {}),
    "nan_inf_negative": (lambda: _poisoned_tail_case(10), 5, {"limit": 15}),
    "nan_inf_negative_parts": (lambda: _poisoned_tail_case(11), 5, {"t_part": 5}),
}


@pytest.mark.parametrize("name", list(_PRUNED))
def test_sweep_pruned_walk_matches_kround_merge(name):
    make, k, opts = _PRUNED[name]
    case = make()
    (ids, d), walks = _merge_pruned(case, k, **opts)
    _eq((ids, d), _selected_whole(case, k))
    nbr, verts, w = case[:3]
    # the kernel's tally: k candidates a real neighbour slot and E a row gathered
    gathered = sum(wk.gathered for wk in walks)
    assert gathered == k * int((nbr >= 0).sum()) + case[3].shape[1] * len(verts)
    assert sum(wk.kept for wk in walks) <= gathered
    if not (np.isnan(w) | (w < 0)).any() and not np.isnan(case[6]).any():
        # inside the plain version's own domain: the JAX reference too
        want = jref.sweep_merge_ref(*_j(*case), k)
        _eq((ids, d), tuple(np.asarray(x)[verts] for x in want))


def test_sweep_pruned_walk_keeps_few_candidates_where_lists_are_full():
    case = _pruned_case(12, t=40, k=5, full=1.0)
    (ids, d), walks = _merge_pruned(case, 5, limit=15)
    _eq((ids, d), _selected_whole(case, 5))
    live = sum(key < _DEAD for key in _keys(*ref.sweep_candidates(*_t(*case))))
    assert sum(wk.kept for wk in walks) < live / 4


def test_sweep_bound_is_a_distance_not_the_kth_key():
    # the rounding tie: a bound at the list's k-th key would drop id 9
    case = _rounding_tie_case()
    want = _selected_whole(case, 4)
    np.testing.assert_array_equal(want[0].numpy()[0], [3, 4, 6, 9])
    _eq(_merge_pruned(case, 4)[0], want)
    np.testing.assert_array_equal(_merge_pruned(case, 4, by_key=True)[0][0][0], [3, 4, 6, -1])


# ---------------------------------------------------------------------------
# frontier_relax
# ---------------------------------------------------------------------------


def _frontier_case(seed, n, r, t, b, n_src):
    """Random frontier_relax instance with every pad convention exercised."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, size=(r, t)).astype(np.int32)
    nbr[rng.random((r, t)) < 0.3] = -1          # padded neighbour slots
    rows = rng.choice(n, size=r, replace=False).astype(np.int32)
    rows[-1] = n                                 # padded receiver row
    w = np.where(nbr >= 0, rng.uniform(1, 9, size=nbr.shape), np.inf).astype(np.float32)
    dist = rng.uniform(0, 30, size=(n + 1, b)).astype(np.float32)
    dist[rng.random((n + 1, b)) < 0.4] = np.inf  # unreached entries
    dist[n] = np.inf                             # dummy row
    dist[:, n_src:] = np.inf                     # padded source columns
    kth = rng.uniform(0, 35, size=n + 1).astype(np.float32)
    kth[n] = np.inf
    src = np.full(b, -1, np.int32)
    src[:n_src] = rng.choice(n, size=n_src, replace=False)
    for i in range(n_src):                       # sources sit at distance 0
        dist[src[i], i] = 0.0
    return nbr, rows, w, dist, kth, src


def _relaxed_full(case):
    """The port's round, scattered into a copy of dist like the JAX form."""
    args = _t(*case)
    tile = ops.frontier_relax(*args)
    np.testing.assert_array_equal(args[3].numpy(), case[3])  # dist only read
    _eq((ref.frontier_relax_ref(*args),), (tile,))
    full = case[3].copy()
    full[case[1]] = tile.numpy()
    return full


@pytest.mark.parametrize("seed,n,r,t,b,n_src", [
    (0, 40, 9, 6, 8, 5),
    (1, 140, 9, 6, 128, 100),
    (2, 150, 40, 17, 16, 11),  # receivers neighbouring each other
    (3, 25, 6, 1, 8, 3),       # single neighbour column
    (4, 60, 12, 5, 3, 3),      # a column count that is no power of two
])
def test_frontier_relax_matches_jax(seed, n, r, t, b, n_src):
    case = _frontier_case(seed, n, r, t, b, n_src)
    got = _relaxed_full(case)
    np.testing.assert_array_equal(got, np.asarray(jref.frontier_relax_ref(*_j(*case))))
    np.testing.assert_array_equal(
        got, np.asarray(jops.frontier_relax(*_j(*case), use_pallas=False)))
    if b % 8 == 0:
        np.testing.assert_array_equal(
            got, np.asarray(jops.frontier_relax(*_j(*case), use_pallas=True)))


def test_frontier_relax_gate_blocks_propagation():
    """A neighbour at dist >= kth must not propagate (checkIns), unless it is
    the column's source vertex, which always propagates."""
    n = 4
    nbr = np.array([[1]], np.int32)
    rows = np.array([0], np.int32)
    w = np.array([[2.0]], np.float32)
    dist = np.full((n + 1, 8), np.inf, np.float32)
    dist[1, 0] = 5.0                  # col 0: src elsewhere, 1 at 5.0
    dist[1, 1] = 0.0                  # col 1: 1 IS the source (dist 0)
    kth = np.full(n + 1, np.inf, np.float32)
    kth[1] = 4.0                      # gate closed: 5.0 >= 4.0, 0.0 < 4.0
    src = np.full(8, -1, np.int32)
    src[0], src[1] = 3, 1
    out = _relaxed_full((nbr, rows, w, dist, kth, src))
    assert np.isinf(out[0, 0]) and out[0, 1] == 2.0
    np.testing.assert_array_equal(out[2:], dist[2:])


def test_frontier_relax_all_pad_row_stays_inf():
    n = 6
    nbr = np.full((2, 3), -1, np.int32)
    rows = np.array([2, n], np.int32)
    w = np.full((2, 3), np.inf, np.float32)
    dist = np.full((n + 1, 8), np.inf, np.float32)
    kth = np.full(n + 1, np.inf, np.float32)
    src = np.full(8, -1, np.int32)
    assert np.isinf(_relaxed_full((nbr, rows, w, dist, kth, src))).all()


def test_frontier_plan_reads_few_chunks_and_splits_only_few_rows():
    """K3's launch shape (Python, like K1's plan): V columns a lane reads at
    once, the fewest 32 * V chunks first, then the narrowest load B and the
    address allow; a warp a (row, chunk) only where the rows would not fill
    the card."""
    warps = 8448  # an H100: 132 SMs x 64 warps
    assert ops.frontier_plan(131072, 64, 0, warps) == (2, 0)   # the usa shape: one chunk
    assert ops.frontier_plan(98241, 472, 0, warps) == (4, 0)   # a flush's narrow bucket
    assert ops.frontier_plan(2780, 472, 0, warps) == (4, 1)    # its highest-degree bucket
    assert ops.frontier_plan(1000, 475, 0, warps) == (1, 1)    # B odd: scalar loads
    assert ops.frontier_plan(1000, 476, 8, warps) == (2, 1)    # 8-byte aligned matrix
    assert ops.frontier_plan(100, 64, 0, warps) == (2, 0)      # one chunk: nothing to split
    assert ops.frontier_plan(5, 1, 0, warps) == (1, 0)


def _bucket_case(seed, n, r, t, b):
    """An engine frontier round at bucket width t: (n+1, t) tables with each
    row's neighbours first and -1 / +inf behind them (the dummy row and some
    rows all pads), receivers half of whose neighbours are receivers too (the
    Jacobi trap), two padded receiver rows aimed at row n, an (n+1, k) table
    whose last column is the pruning bound, and padded source columns."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(n, size=r, replace=False).astype(np.int32)
    deg = rng.integers(0, t + 1, size=n + 1)
    deg[rng.random(n + 1) < 0.1] = 0
    deg[n] = 0
    nbr = rng.integers(0, n, size=(n + 1, t))
    own = rng.random((n + 1, t)) < 0.5
    nbr[own] = rows[rng.integers(0, r, size=int(own.sum()))]
    nbr = np.where(np.arange(t)[None, :] < deg[:, None], nbr, -1).astype(np.int32)
    w = np.where(nbr >= 0, rng.integers(1, 9, size=nbr.shape), np.inf).astype(np.float32)
    rows[-2:] = n
    dist = rng.integers(0, 40, size=(n + 1, b)).astype(np.float32)
    dist[rng.random((n + 1, b)) < 0.5] = np.inf
    dist[n] = np.inf
    n_src = max(1, b - 2)
    src = np.full(b, -1, np.int32)
    src[:n_src] = rng.choice(n, size=n_src, replace=False)
    dist[:, n_src:] = np.inf
    for i in range(n_src):
        dist[src[i], i] = 0.0
    vk_d = np.sort(rng.integers(0, 50, size=(n + 1, 3)), axis=1).astype(np.float32)
    vk_d[n] = np.inf
    return nbr, w, rows, dist, vk_d, src


@pytest.mark.parametrize("seed,n,r,t,b,pallas", [
    (0, 60, 12, 8, 8, True),
    (1, 120, 30, 32, 7, False),   # B not a multiple of 4
    (2, 300, 40, 128, 64, False),
    (3, 400, 25, 200, 13, False),  # tau': several 32-slot passes
])
def test_frontier_relax_rows_matches_jax_engine_round(seed, n, r, t, b, pallas):
    nbr_tab, w_tab, rows, dist, vk_d, src = _bucket_case(seed, n, r, t, b)
    kth = np.ascontiguousarray(vk_d[:, -1])
    tile, changed = ops.frontier_relax_rows(*_t(nbr_tab, w_tab, rows, dist, kth, src))
    assert changed.dtype == torch.bool and changed.shape == (r,)
    for use_pallas in (False, True) if pallas else (False,):
        new, jchanged = jax_frontier_round(*_j(nbr_tab, w_tab, rows, dist, vk_d, src),
                                           use_pallas=use_pallas)
        _eq((tile, changed), (np.asarray(new)[rows], np.asarray(jchanged)))
    _eq((tile,), (ops.frontier_relax(*_t(nbr_tab[rows], rows, w_tab[rows], dist, kth, src)),))
    assert changed.any() and not changed.all()
    assert np.isinf(tile.numpy()[-2:]).all()        # padded rows read the all-pad dummy row
    idle = rows[:-2][nbr_tab[rows[:-2]].max(axis=1) < 0]
    assert idle.size                                 # rows whose table row is all pads
    np.testing.assert_array_equal(tile.numpy()[np.isin(rows, idle)], dist[idle])


# ---------------------------------------------------------------------------
# the plain tensor ops around the kernels
# ---------------------------------------------------------------------------


def _rows_case(seed, n=30, k=5, r=9, p=4, ndel=6):
    rng = np.random.default_rng(seed)
    vk_ids = rng.integers(-1, n, size=(n + 1, k)).astype(np.int32)
    vk_d = np.sort(rng.uniform(0, 50, (n + 1, k)), axis=1).astype(np.float32)
    vk_d[vk_ids < 0] = np.inf
    vk_ids[n], vk_d[n] = -1, np.inf
    rows = rng.choice(n, size=r, replace=False).astype(np.int32)
    rows[-2:] = n
    cand_ids = rng.integers(-1, n, size=(r, p)).astype(np.int32)
    cand_d = rng.uniform(0, 50, (r, p)).astype(np.float32)
    cand_ids[-2:] = -1
    cand_d[cand_ids < 0] = np.inf
    dels = rng.choice(n, size=ndel, replace=False).astype(np.int32)
    return vk_ids, vk_d, rows, dels, cand_ids, cand_d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_ops_match_jax(seed):
    vk_ids, vk_d, rows, dels, cand_ids, cand_d = _rows_case(seed)
    k = vk_ids.shape[1]
    np.testing.assert_array_equal(
        ops.rows_containing(*_t(vk_ids, dels)).numpy(),
        np.asarray(jops.rows_containing(*_j(vk_ids, dels))))
    _eq(ops.rows_merge(*_t(vk_ids, vk_d, rows, cand_ids, cand_d), k),
        jops.rows_merge(*_j(vk_ids, vk_d, rows, cand_ids, cand_d), k, use_pallas=False))
    _eq(ops.rows_purge(*_t(vk_ids, vk_d, rows, dels), k),
        jops.rows_purge(*_j(vk_ids, vk_d, rows, dels), k, use_pallas=False))
    _eq(ops.rows_purge_merge(*_t(vk_ids, vk_d, rows, dels, cand_ids, cand_d), k),
        jops.rows_purge_merge(*_j(vk_ids, vk_d, rows, dels, cand_ids, cand_d), k,
                              use_pallas=True))


def test_serve_gather_matches_jax():
    vk_ids, vk_d, *_ = _rows_case(7)
    rng = np.random.default_rng(7)
    q = rng.integers(0, 30, size=50).astype(np.int32)
    ks = rng.integers(0, 6, size=50).astype(np.int32)
    _eq(ops.serve_gather(*_t(vk_ids, vk_d, q, ks)), jops.serve_gather(*_j(vk_ids, vk_d, q, ks)))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    """The plain version is chosen by where the tensor lies; a launch counter
    moves only where a kernel is launched, so it stays at zero on the CPU."""
    ops.reset_launches()
    ids, d = _topk_case(4, 16, np.float32, 0)
    ops.topk_merge(*_t(ids, d), 3)
    ops.minplus_matmul(torch.from_numpy(d), torch.from_numpy(d.T.copy()))
    ops.retrieval_topk(torch.from_numpy(d), 3)
    q = torch.zeros((1, 4, 2, 64))
    ops.flash_attention(q, q[:, :, :1], q[:, :, :1], causal=True)
    assert ops.launches() == {"topk_merge": 0, "sweep_merge": 0, "sweep_merge_levels": 0,
                              "frontier_relax": 0, "minplus": 0, "retrieval_topk": 0,
                              "flash_attention": 0}
