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

from repro.kernels import ops as jops
from repro.kernels import ref as jref
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
    """The port's in-place result (full tables) and its tile result."""
    args = _t(*case)
    tile = ops.sweep_merge(*args, k, inplace=False)
    np.testing.assert_array_equal(args[5].numpy(), case[5])  # tables only read
    np.testing.assert_array_equal(args[6].numpy(), case[6])
    full = ops.sweep_merge(*_t(*case), k, inplace=True)
    return full, tile


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
    tile = ops.sweep_merge(*_t(*case), k, inplace=False)
    want = jops.sweep_merge(*_j(*case), k, use_pallas=False)
    _eq(tile, (np.asarray(want[0])[verts], np.asarray(want[1])[verts]))


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
    assert ops.launches() == {"topk_merge": 0, "sweep_merge": 0, "frontier_relax": 0}
