"""Public wrappers around the CUDA kernels, and the plain-torch table ops.

Eight functions here launch a hand-written kernel (``csrc/*.cu``):
``topk_merge``, ``sweep_merge`` and ``sweep_merge_levels`` (K2: one call, one
repair round; one call, a whole sweep), ``frontier_relax`` and
``frontier_relax_rows`` (K3: the JAX package's signature; the engine's fused
form), ``minplus_matmul``, ``retrieval_topk`` and ``flash_attention``.
Given CUDA tensors and ``use_kernel=True`` (the default) a wrapper checks
device, dtype, shape and contiguity, launches its kernel on the current
stream and raises if the launch is refused; it never gives way to the plain
version. Given CPU tensors it
runs the plain version in ``ref.py``, and only because the tensors lie on the
CPU. ``use_kernel=False`` asks for the plain version on whatever device the
tensors are on (the on-card comparison uses that).

Every kernel launch adds one to ``LAUNCHES[name]``; nothing else does.

Under the op-level count (``launch/op_cost.py``) each of the eight is one op
(``_entry``): its tensors' bytes and its plain version's matmul FLOPs, its
body run with the count paused, so the count is the same whichever version
runs. On ``meta`` tensors (the dry run's) each returns empty outputs of the
shapes its docstring states and runs nothing.

The remaining functions (``serve_gather``, ``rows_containing``, ``rows_merge``,
``rows_purge``, ``rows_purge_merge``, and the sharded engine's ``shard_*`` and
``halo_*`` ops) are plain tensor code around ``topk_merge``, as they were plain
array code around it in the JAX package. Tables stay int32 / float32; indices
widen to int64 only at the indexing call.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import inspect

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import _build, ref

LAUNCHES = {"topk_merge": 0, "sweep_merge": 0, "sweep_merge_levels": 0, "frontier_relax": 0,
            "minplus": 0, "retrieval_topk": 0, "flash_attention": 0}

# what one block may have on an H100 (227 KB of the SM's 256 KB)
MAX_SMEM_BYTES = 232448
_INF = float("inf")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> dict[str, int]:
    return dict(LAUNCHES)


# ----------------------------------------------------------------------
# binding helpers
# ----------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> (argument types, return type); every pointer and the stream
# go as c_void_p, or ctypes would cut them to 32 bits
_SIGNATURES = {
    "knn_topk_merge": ([_P] * 4 + [_I] * 5 + [_P], _I),
    "knn_topk_geometry": ([_I], _I),
    "knn_sweep_merge": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "knn_sweep_levels": ([_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P], _I),
    "knn_sweep_levels_grid": ([_I], _I),
    "knn_sweep_group_cap": ([_I, _I], _I),
    "knn_sweep_geometry": ([_I], _I),
    "knn_frontier_relax": ([_P] * 7 + [_I] * 5 + [_P], _I),
    "knn_frontier_relax_rows": ([_P] * 8 + [_I] * 5 + [_P], _I),
    "knn_minplus": ([_P] * 3 + [_I] * 3 + [_P] * 5, _I),
    "knn_minplus_bits": ([_P, _P, _I, _I, _I, _P, _P, _P], _I),
    "knn_minplus_geometry": ([_I], _I),
    "knn_retrieval_topk": ([_P] + [_I] * 5 + [_P] * 5, _I),
    "knn_retrieval_slots": ([_I, _I], _I),
    "knn_flash_attention": ([_P] * 4 + [_I] * 8 + [ctypes.c_float, _P], _I),
}
_fns: dict[str, object] = {}


def _fn(lib_name: str, fn_name: str):
    fn = _fns.get(fn_name)
    if fn is None:
        fn = getattr(_build.load(lib_name), fn_name)
        fn.argtypes, fn.restype = _SIGNATURES[fn_name]
        _fns[fn_name] = fn
    return fn


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launched(kernel: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error code {code}")
    LAUNCHES[kernel] += 1


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ----------------------------------------------------------------------
# the kernel entries as the op-level count sees them
# ----------------------------------------------------------------------

# the op-level counts running (launch/op_cost.count()); an entry reports to
# each
COUNTS: list = []


def _entry(outputs, flops=None, written=()):
    """Marks a kernel entry point. ``outputs(a)``: its outputs as empty
    tensors (``a``: its arguments by name), what it returns on ``meta``;
    ``flops(a)``: (matmul FLOPs of its plain version, their dtype);
    ``written``: the arguments it writes in place. Under a count it is one op
    of every tensor it reads once and every tensor it writes once, its body
    run with the count paused."""
    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def entry(*args, **kwargs):
            on_meta = any(isinstance(x, torch.Tensor) and x.is_meta
                          for x in (*args, *kwargs.values()))
            if not (COUNTS or on_meta):
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = bound.arguments
            with contextlib.ExitStack() as paused:
                for count in COUNTS:
                    paused.enter_context(count.paused())
                out = outputs(a) if on_meta else fn(*args, **kwargs)
            if COUNTS:
                n, dtype = flops(a) if flops else (0, None)
                tensors = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
                for count in COUNTS:
                    count.kernel(fn.__name__, tensors, out, n, dtype,
                                 [a[name] for name in written])
            return out

        return entry

    return wrap


def _empty(like: torch.Tensor, shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


def _rows_k(rows_of: str, dtype_of: str | None = None):
    """Outputs of a K1/K2-style entry: (rows, k) int32 ids and (rows, k)
    distances in ``a[dtype_of]``'s type (float32 without it)."""
    def outputs(a):
        r, k = a[rows_of].shape[0], a["k"]
        dt = a[dtype_of].dtype if dtype_of else torch.float32
        return _empty(a[rows_of], (r, k), torch.int32), _empty(a[rows_of], (r, k), dt)

    return outputs


# ----------------------------------------------------------------------
# K1 topk_merge
# ----------------------------------------------------------------------


# keys a lane of K1's warp may hold (csrc/kround.cuh: kMaxRegs choices), the
# warp's candidates, and the largest k (csrc/topk_merge.cu: kMaxK)
TOPK_REGS = (4, 8, 16, 24)
TOPK_CANDS = 24 * 32
TOPK_MAX_K = TOPK_CANDS // 2


def topk_plan(c: int, k: int) -> tuple[int, int]:
    """K1's registers a lane and candidates a group for a C-wide row: all C
    in one group on the fewest registers that hold them; past 768, groups of
    768 - k new candidates, each merged with the k best of the groups before.
    """
    if not 1 <= k <= TOPK_MAX_K:
        raise ValueError(f"topk_merge: k={k}, the kernel takes 1 <= k <= {TOPK_MAX_K}")
    if c <= TOPK_CANDS:
        return next(r for r in TOPK_REGS if 32 * r >= c), max(1, c)
    return TOPK_REGS[-1], TOPK_CANDS - k


@_entry(_rows_k("cand_ids", "cand_d"))
def topk_merge(cand_ids: torch.Tensor, cand_d: torch.Tensor, k: int, *, use_kernel: bool = True):
    """Top-k distinct-id merge. cand_ids (B, C) int32 (-1 invalid), cand_d
    (B, C) float32 or float16. Returns ((B, k) int32, (B, k) of cand_d's type).

    CUDA kernel: ``csrc/topk_merge.cu`` (replaces ``topk_merge_pallas``). A
    warp a row, the candidates in registers (``topk_plan``), K2's barrier-free
    selection; any C, no padding of B or C, 1 <= k <= 384. Bound by bytes:
    B*C*8 read, B*k*8 written. float16 distances are widened to float32 here
    and narrowed back, as the TPU kernel's body did.
    """
    if not (cand_ids.is_cuda and use_kernel):
        return ref.topk_merge_ref(cand_ids, cand_d, k)
    dev = cand_ids.device
    b, c = cand_ids.shape
    out_dtype = cand_d.dtype
    if out_dtype == torch.float16:
        cand_d = cand_d.to(torch.float32)
    _check("cand_ids", cand_ids, torch.int32, (b, c), dev)
    _check("cand_d", cand_d, torch.float32, (b, c), dev)
    regs, group = topk_plan(c, k)
    geometry = _fn("topk_merge", "knn_topk_geometry")
    if (geometry(0), geometry(1)) != (TOPK_CANDS, TOPK_MAX_K):
        raise RuntimeError(f"topk_merge: kernel holds {geometry(0)} candidates and k <= "
                           f"{geometry(1)}, the wrapper plans {TOPK_CANDS} and {TOPK_MAX_K}")
    out_ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b:
        with torch.cuda.device(dev):
            code = _fn("topk_merge", "knn_topk_merge")(
                cand_ids.data_ptr(), cand_d.data_ptr(), out_ids.data_ptr(),
                out_d.data_ptr(), b, c, k, regs, group, _stream(dev),
            )
        _launched("topk_merge", code)
    return out_ids, out_d.to(out_dtype)


# ----------------------------------------------------------------------
# K2 sweep_merge
# ----------------------------------------------------------------------


def _sweep_group(t: int, k: int, e: int, t_group: int | None) -> int:
    """Neighbours per group: all T where the kernel's registers hold them."""
    cap = _fn("sweep_merge", "knn_sweep_group_cap")(k, e)
    if cap < 1:
        cands = _fn("sweep_merge", "knn_sweep_geometry")(1)
        raise ValueError(f"sweep_merge: k={k}, E={e} leave no room for a neighbour "
                         f"in the kernel's {cands} candidates a row")
    group = min(max(1, t), cap)
    return group if t_group is None else max(1, min(group, t_group))


@_entry(_rows_k("nbr"))
def sweep_merge(
    nbr: torch.Tensor,      # (S, T) int32 neighbour rows, -1 = padded slot
    verts: torch.Tensor,    # (S,) int32 target rows, n (dummy) = padded row
    w: torch.Tensor,        # (S, T) float32 edge weights, +inf on pads
    ex_ids: torch.Tensor,   # (n+1, E) int32 per-vertex extra candidates
    ex_d: torch.Tensor,     # (n+1, E) float32
    vk_ids: torch.Tensor,   # (n+1, k) int32 live table
    vk_d: torch.Tensor,     # (n+1, k) float32 live table
    k: int,
    *,
    use_kernel: bool = True,
    t_group: int | None = None,
):
    """Fused sweep step: gather + shift + dedup top-k.

    Leaves the tables untouched and returns the merged rows as fresh (S, k)
    tiles, row i for ``verts[i]``. The engine's repair rounds use it:
    repaired rows read each other, so they must all read the pre-round
    tables, and the caller scatters after it has compared. The construction
    sweeps, which write in place, are ``sweep_merge_levels``.

    CUDA kernel: ``csrc/sweep_merge.cu`` (replaces ``sweep_merge_pallas``).
    One warp per target row, candidates only ever in registers, no block
    barrier. Bound by bytes: S*T*8 of schedule, the distinct neighbour rows and
    S extras rows read, S*k*8 written. Rows whose T*k+E candidates exceed the
    warp's registers are walked in groups of neighbours, carrying the running
    k best; ``t_group`` asks for smaller groups (the on-card check does).
    """
    if not (vk_ids.is_cuda and use_kernel):
        return ref.sweep_merge_ref(nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d, k)
    dev = vk_ids.device
    s, t = nbr.shape
    n1 = vk_ids.shape[0]
    e = ex_ids.shape[1]
    _check("nbr", nbr, torch.int32, (s, t), dev)
    _check("verts", verts, torch.int32, (s,), dev)
    _check("w", w, torch.float32, (s, t), dev)
    _check("ex_ids", ex_ids, torch.int32, (n1, e), dev)
    _check("ex_d", ex_d, torch.float32, (n1, e), dev)
    _check("vk_ids", vk_ids, torch.int32, (n1, k), dev)
    _check("vk_d", vk_d, torch.float32, (n1, k), dev)
    group = _sweep_group(t, k, e, t_group)
    out_ids = torch.empty((s, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((s, k), dtype=torch.float32, device=dev)
    if s:
        with torch.cuda.device(dev):
            code = _fn("sweep_merge", "knn_sweep_merge")(
                nbr.data_ptr(), verts.data_ptr(), w.data_ptr(),
                ex_ids.data_ptr(), ex_d.data_ptr(), vk_ids.data_ptr(), vk_d.data_ptr(),
                out_ids.data_ptr(), out_d.data_ptr(),
                s, t, k, e, group, _stream(dev),
            )
        _launched("sweep_merge", code)
    return out_ids, out_d


@_entry(lambda a: 0, written=("vk_ids", "vk_d"))
def sweep_merge_levels(
    buckets,                # sequence of (nbr (R, t), w (R, t), verts (R,)), rows level after level
    levels: torch.Tensor,   # (L, 3) int32 rows (bucket, first row, row count), in level order
    ex_ids: torch.Tensor,   # (n+1, E) int32 per-vertex extra candidates
    ex_d: torch.Tensor,     # (n+1, E) float32
    vk_ids: torch.Tensor,   # (n+1, k) int32 live table, written in place
    vk_d: torch.Tensor,     # (n+1, k) float32 live table, written in place
    k: int,
    *,
    use_kernel: bool = True,
) -> int:
    """A whole construction sweep: for each level in order, the
    ``sweep_merge`` of its rows, stored at rows ``verts`` of the live tables.
    Each level's rows read only rows of earlier levels (the level invariant).
    Padded rows (``verts == n``) are not stored, so the dummy row stays
    (-1, +inf). Returns the number of blocks launched (0 on the plain path).

    CUDA kernel: ``knn_sweep_levels`` in ``csrc/sweep_merge.cu``, ONE
    cooperative launch of as many blocks as the card holds at once, which walk
    ``levels`` with a grid barrier after each: a warp a row, or, for a level
    of few rows wider than one group of neighbours, a warp a (row, group)
    part, the last part's warp merging the row. The kernel reads the
    buckets' addresses and widths from a (B, 4) table built here from
    ``buckets``. A launch the runtime refuses raises. The plain path walks
    the same ``levels`` table with ``ref.sweep_merge_ref``, one level at a
    time.
    """
    n1 = vk_ids.shape[0]
    if not (vk_ids.is_cuda and use_kernel):
        for bid, off, size in levels.tolist():
            nbr, w, verts = (x[off : off + size] for x in buckets[bid])
            m_ids, m_d = ref.sweep_merge_ref(nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d, k)
            keep = verts != n1 - 1
            rows = verts[keep].long()
            vk_ids[rows] = m_ids[keep]
            vk_d[rows] = m_d[keep]
        return 0
    dev = vk_ids.device
    e = ex_ids.shape[1]
    _check("ex_ids", ex_ids, torch.int32, (n1, e), dev)
    _check("ex_d", ex_d, torch.float32, (n1, e), dev)
    _check("vk_ids", vk_ids, torch.int32, (n1, k), dev)
    _check("vk_d", vk_d, torch.float32, (n1, k), dev)
    if ex_ids.data_ptr() == vk_ids.data_ptr() or ex_d.data_ptr() == vk_d.data_ptr():
        raise ValueError("sweep_merge_levels: the extras must not be the live tables")
    _check("levels", levels, torch.int32, (levels.shape[0], 3), dev)
    for nbr, w, verts in buckets:
        r, t = nbr.shape
        _check("nbr", nbr, torch.int32, (r, t), dev)
        _check("w", w, torch.float32, (r, t), dev)
        _check("verts", verts, torch.int32, (r,), dev)
    _sweep_group(1, k, e, None)
    table = torch.tensor([[nbr.data_ptr(), w.data_ptr(), verts.data_ptr(), nbr.shape[1]]
                          for nbr, w, verts in buckets], dtype=torch.int64).reshape(-1, 4)
    table = table.to(dev, non_blocking=True)
    with torch.cuda.device(dev):
        grid = _fn("sweep_merge", "knn_sweep_levels_grid")(k)
        warps = grid * _fn("sweep_merge", "knn_sweep_geometry")(0)
        # a part (k keys) and a counter for each warp of the grid, the barrier's two words
        scratch = torch.empty(warps * k, dtype=torch.int64, device=dev)
        counts = torch.zeros(warps + 2, dtype=torch.int32, device=dev)
        code = _fn("sweep_merge", "knn_sweep_levels")(
            levels.data_ptr(), levels.shape[0], table.data_ptr(), ex_ids.data_ptr(),
            ex_d.data_ptr(), vk_ids.data_ptr(), vk_d.data_ptr(), k, e, n1 - 1, grid,
            scratch.data_ptr(), counts.data_ptr(), counts[-2:].data_ptr(), _stream(dev),
        )
    if levels.shape[0]:
        _launched("sweep_merge_levels", code)
    return grid


# ----------------------------------------------------------------------
# K3 frontier_relax
# ----------------------------------------------------------------------


def frontier_plan(r: int, b: int, ptr: int, resident_warps: int) -> tuple[int, int]:
    """K3's launch shape for R receivers of B columns, the matrix at address
    ``ptr``: V, the columns a lane reads at once (the fewest chunks of 32 * V
    over B, then the narrowest load that B and the address allow), and
    whether each (receiver, chunk) gets a warp of its own (1) rather than
    each receiver (0): only where R receivers would leave some of the card's
    ``resident_warps`` idle (a round's highest-degree bucket holds a few
    thousand rows of hundreds of neighbours, a long chain of loads a warp)."""
    fits = [v for v in (1, 2, 4) if b % v == 0 and ptr % (4 * v) == 0]
    vec = min(fits, key=lambda v: (-(-b // (32 * v)), v))
    return vec, int(r < resident_warps and b > 32 * vec)


@functools.lru_cache(maxsize=None)
def resident_warps(dev) -> int:
    """Warps the card holds at once: its SMs times the warps an SM holds."""
    props = torch.cuda.get_device_properties(dev)
    return props.multi_processor_count * props.max_threads_per_multi_processor // 32


def _frontier_checks(dist, kth, src, dev) -> int:
    n1, b = dist.shape
    _check("dist", dist, torch.float32, (n1, b), dev)
    _check("kth", kth, torch.float32, (n1,), dev)
    _check("src", src, torch.int32, (b,), dev)
    return b


@_entry(lambda a: _empty(a["dist"], (a["nbr"].shape[0], a["dist"].shape[1]), torch.float32))
def frontier_relax(
    nbr: torch.Tensor,   # (R, T) int32 BNS neighbour ids per receiver, -1 pad
    rows: torch.Tensor,  # (R,) int32 receiver rows, n (dummy) = padding
    w: torch.Tensor,     # (R, T) float32 BNS edge weights, +inf on pads
    dist: torch.Tensor,  # (n+1, B) float32 multi-source tentative distances
    kth: torch.Tensor,   # (n+1,) float32 k-th-distance pruning bounds
    src: torch.Tensor,   # (B,) int32 source vertex per column, -1 pad
    *,
    use_kernel: bool = True,
) -> torch.Tensor:
    """One batched pruned-relaxation round of the checkIns frontier.

    Column c of ``dist`` is the tentative distance field of source ``src[c]``;
    a neighbour u only propagates into column c while ``dist[u, c] < kth[u]``
    (Algorithm 4's checkIns test) or u is the source itself. Returns the new
    receiver rows as a fresh (R, B) tile, row i for ``rows[i]``; ``dist`` is
    only read, so every read sees pre-round values (pure Jacobi) for any
    receiver set. The engine calls ``frontier_relax_rows``.

    CUDA kernel: ``knn_frontier_relax`` in ``csrc/frontier_relax.cu`` (replaces
    ``frontier_relax_pallas``). A warp a receiver row (or a part of its
    columns, ``frontier_plan``), the schedule read by the lanes together,
    neighbour rows loaded two at a time. Bound by bytes: R*T*8 of
    schedule, the distinct neighbour rows and R own rows (B*4 each) read,
    R*B*4 written.
    """
    if not (dist.is_cuda and use_kernel):
        return ref.frontier_relax_ref(nbr, rows, w, dist, kth, src)
    dev = dist.device
    r, t = nbr.shape
    _check("nbr", nbr, torch.int32, (r, t), dev)
    _check("rows", rows, torch.int32, (r,), dev)
    _check("w", w, torch.float32, (r, t), dev)
    b = _frontier_checks(dist, kth, src, dev)
    out = torch.empty((r, b), dtype=torch.float32, device=dev)
    if r and b:
        with torch.cuda.device(dev):
            code = _fn("frontier_relax", "knn_frontier_relax")(
                nbr.data_ptr(), rows.data_ptr(), w.data_ptr(), dist.data_ptr(),
                kth.data_ptr(), src.data_ptr(), out.data_ptr(),
                r, t, b, *frontier_plan(r, b, dist.data_ptr(), resident_warps(dev)),
                _stream(dev),
            )
        _launched("frontier_relax", code)
    return out


@_entry(lambda a: (
    _empty(a["dist"], (a["rows"].shape[0], a["dist"].shape[1]), torch.float32),
    _empty(a["dist"], (a["rows"].shape[0],), torch.bool)))
def frontier_relax_rows(
    nbr_tab: torch.Tensor,  # (n+1, T) int32 bucket table of BNS neighbour ids, -1 pad
    w_tab: torch.Tensor,    # (n+1, T) float32 bucket table of BNS edge weights
    rows: torch.Tensor,     # (R,) int32 receiver rows
    dist: torch.Tensor,     # (n+1, B) float32 multi-source tentative distances
    kth: torch.Tensor,      # (n+1,) float32 k-th-distance pruning bounds
    src: torch.Tensor,      # (B,) int32 source vertex per column, -1 pad
    *,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The engine's frontier round: ``frontier_relax`` with receiver i's
    schedule read from row ``rows[i]`` of the bucket tables, and the changed
    mask. Returns the (R, B) tile and an (R,) bool, ``(tile <
    dist[rows]).any(1)``; ``dist`` is only read.

    CUDA kernel: ``knn_frontier_relax_rows`` in ``csrc/frontier_relax.cu``, the
    kernel of ``frontier_relax`` reading the tables in place (no gather of
    the schedule) and writing each row's changed flag from the registers that
    hold its old and new values. Counted as a ``frontier_relax`` launch.
    """
    if not (dist.is_cuda and use_kernel):
        return ref.frontier_relax_rows_ref(nbr_tab, w_tab, rows, dist, kth, src)
    dev = dist.device
    r = rows.shape[0]
    n1, t = nbr_tab.shape
    _check("nbr_tab", nbr_tab, torch.int32, (n1, t), dev)
    _check("w_tab", w_tab, torch.float32, (n1, t), dev)
    _check("rows", rows, torch.int32, (r,), dev)
    if dist.shape[0] != n1:
        raise ValueError(f"frontier_relax_rows: tables of {n1} rows, dist of {dist.shape[0]}")
    b = _frontier_checks(dist, kth, src, dev)
    out = torch.empty((r, b), dtype=torch.float32, device=dev)
    changed = torch.zeros((r,), dtype=torch.bool, device=dev)
    if r and b:
        with torch.cuda.device(dev):
            code = _fn("frontier_relax", "knn_frontier_relax_rows")(
                nbr_tab.data_ptr(), w_tab.data_ptr(), rows.data_ptr(), dist.data_ptr(),
                kth.data_ptr(), src.data_ptr(), out.data_ptr(), changed.data_ptr(),
                r, t, b, *frontier_plan(r, b, dist.data_ptr(), resident_warps(dev)),
                _stream(dev),
            )
        _launched("frontier_relax", code)
    return out, changed


# ----------------------------------------------------------------------
# K4 minplus
# ----------------------------------------------------------------------


@_entry(lambda a: _empty(a["a"], (a["a"].shape[0], a["b"].shape[1]), a["a"].dtype),
        flops=lambda a: (2 * a["a"].shape[0] * a["a"].shape[1] * a["b"].shape[1], torch.float32))
def minplus_matmul(a: torch.Tensor, b: torch.Tensor, *, use_kernel: bool = True,
                   pairs: torch.Tensor | None = None) -> torch.Tensor:
    """Tropical (min, +) product ``C = A (+,min) B``: (M, K) x (K, N) -> (M, N).

    Math in float32, output in ``a``'s type: float16 / bfloat16 inputs are
    widened here and the result narrowed back, as the TPU kernel's body did.
    +inf is inert and NaN propagates.

    CUDA kernel: ``csrc/minplus.cu`` (replaces ``minplus_matmul_pallas``).
    A first kernel marks each 128-row x 32-t slice of A and 32-t x 128-column
    slice of B as all +inf and/or poisoned (NaN or -inf); the product kernel
    then walks, for each 128 x 128 output tile, only the t slices whose pair
    is not inert, tiles with the most live slices first (the order is computed
    here from the bits, ``ref.minplus_live_counts``). Ragged edges read as
    +inf inside the kernels, so nothing is padded here. Bound: the input's
    bytes where most pairs are inert (the certificate's adjacency), else
    2*M*K*N operations (one add and one min per term) on the CUDA cores.

    Both kernels count as one launch of ``minplus``.

    ``pairs``, an int64 (1,) tensor on the same device, gets the number of
    (output tile, t slice) pairs walked added to it; on the CPU, the number the
    slice bits give (what the kernel would walk).
    """
    if pairs is not None:
        _check("pairs", pairs, torch.int64, (1,), a.device)
    if not (a.is_cuda and use_kernel):
        out = ref.minplus_matmul_ref(a, b)
        if pairs is not None:
            pairs += ref.minplus_live_counts(*ref.minplus_slice_bits(a, b)).sum()
        return out
    dev = a.device
    m, kd = a.shape
    if b.ndim != 2 or b.shape[0] != kd:
        raise ValueError(
            f"minplus_matmul: shapes {tuple(a.shape)} and {tuple(b.shape)} do not chain"
        )
    n = b.shape[1]
    af, bf = a.to(torch.float32), b.to(torch.float32)
    _check("a", af, torch.float32, (m, kd), dev)
    _check("b", bf, torch.float32, (kd, n), dev)
    geometry = _fn("minplus", "knn_minplus_geometry")
    tile, depth, ring = geometry(0), geometry(1), geometry(2)
    if (tile, depth) != (ref.MINPLUS_TILE, ref.MINPLUS_DEPTH):
        raise RuntimeError(f"minplus: kernel slices {tile} x {depth}, plain bits "
                           f"{ref.MINPLUS_TILE} x {ref.MINPLUS_DEPTH}")
    n_t = -(-kd // depth)
    if ring + 4 * n_t > MAX_SMEM_BYTES or -(-m // tile) > 65535:
        raise ValueError(f"minplus_matmul: ({m}, {kd}) x ({kd}, {n}) is past what the "
                         f"kernel takes (K <= {(MAX_SMEM_BYTES - ring) // 4 * depth}, "
                         f"M <= {65535 * tile})")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    a_bits = torch.empty((-(-m // tile), n_t), dtype=torch.uint8, device=dev)
    b_bits = torch.empty((n_t, -(-n // tile)), dtype=torch.uint8, device=dev)
    if m and n:
        with torch.cuda.device(dev):
            code = _fn("minplus", "knn_minplus_bits")(
                af.data_ptr(), bf.data_ptr(), m, kd, n, a_bits.data_ptr(), b_bits.data_ptr(),
                _stream(dev),
            )
            if code == 0:
                live = ref.minplus_live_counts(a_bits, b_bits).flatten()
                order = torch.argsort(live, descending=True, stable=True).to(torch.int32)
                code = _fn("minplus", "knn_minplus")(
                    af.data_ptr(), bf.data_ptr(), out.data_ptr(), m, kd, n, a_bits.data_ptr(),
                    b_bits.data_ptr(), order.data_ptr(),
                    None if pairs is None else pairs.data_ptr(), _stream(dev),
                )
        _launched("minplus", code)
    return out.to(a.dtype)


# ----------------------------------------------------------------------
# K5 retrieval_topk
# ----------------------------------------------------------------------

# largest k the kernel takes: a block keeps two regions of k keys in shared
# memory, and its last step orders at most 1,024 keys
RETRIEVAL_MAX_K = 1024
_RETRIEVAL_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# fewest columns a part of a row takes, and most keys (parts x k) the last
# block of a row merges
RETRIEVAL_MIN_PART = 4096
RETRIEVAL_MERGE_KEYS = 32768
# (device, stream) -> (arrival counters, scratch): kept between calls
_RETRIEVAL_BUFFERS: dict = {}


def retrieval_plan(b: int, n: int, k: int, slots: int) -> int:
    """K5's parts a row for B rows of N columns: as many blocks as the card
    holds at once (``slots``, one wave), no part narrower than
    ``RETRIEVAL_MIN_PART`` columns, at most ``RETRIEVAL_MERGE_KEYS`` keys for
    the row's merge, fewer than 2^31 blocks. At least 1."""
    b = max(1, b)
    return max(1, min(slots // b, n // RETRIEVAL_MIN_PART, RETRIEVAL_MERGE_KEYS // k,
                      (2**31 - 1) // b))


@functools.lru_cache(maxsize=None)
def retrieval_slots(dev, dtype: torch.dtype, k: int) -> int:
    """Blocks of K5 (for this score dtype and k) the card holds at once."""
    with torch.cuda.device(dev):
        slots = _fn("retrieval_topk", "knn_retrieval_slots")(_RETRIEVAL_DTYPES[dtype], k)
    if slots < 1:
        raise RuntimeError(f"retrieval_topk: occupancy query failed with error code {-slots}")
    return slots


def _retrieval_buffers(dev, stream: int, rows: int, parts: int, k: int):
    """The (device, stream)'s arrival counters (zeros, left zero by every
    launch) and scratch keys, grown to ``rows`` and to ``parts`` parts."""
    arrivals, scratch = _RETRIEVAL_BUFFERS.get((dev, stream), (None, None))
    pk = parts * k
    need = rows * (pk + pk % 2) if parts > 1 else 0
    if arrivals is None or arrivals.numel() < rows:
        arrivals = torch.zeros(rows, dtype=torch.int32, device=dev)
    if scratch is None or scratch.numel() < need:
        scratch = torch.empty(max(need, 1), dtype=torch.int64, device=dev)
    _RETRIEVAL_BUFFERS[(dev, stream)] = (arrivals, scratch)
    return arrivals, scratch


@_entry(lambda a: (_empty(a["scores"], (a["scores"].shape[0], a["k"]), torch.int32),
                   _empty(a["scores"], (a["scores"].shape[0], a["k"]), a["scores"].dtype)))
def retrieval_topk(scores: torch.Tensor, k: int, *, use_kernel: bool = True):
    """k largest scores per row and their column indices.

    scores (B, N) float32, float16 or bfloat16 (math in float32). Returns
    ((B, k) int32 ids, (B, k) scores in the input type), best first; equal
    scores go to the smaller column. A -inf score gives (-1, -inf), and so
    does every slot past the row's last finite score (N < k included), as in
    the JAX package's kernel path. NaN is read as -inf, -0.0 as +0.0, +inf is
    an ordinary largest score. k <= 1024; any B.

    CUDA kernel: ``csrc/retrieval_topk.cu`` (replaces ``retrieval_topk_pallas``).
    One launch a call: ``retrieval_plan`` parts a row, each streaming its
    columns once past a running threshold, the last part of a row to arrive
    merging the parts' k best. Bound by bytes: B*N scores read once, B*k*8
    written.
    """
    if not 1 <= k <= RETRIEVAL_MAX_K:
        raise ValueError(f"retrieval_topk: k={k}, the kernel takes 1 <= k <= {RETRIEVAL_MAX_K}")
    if not (scores.is_cuda and use_kernel):
        return ref.retrieval_topk_ref(scores, k)
    dev = scores.device
    b, n = scores.shape
    if scores.dtype not in _RETRIEVAL_DTYPES:
        raise TypeError(f"retrieval_topk: dtype {scores.dtype}, expected float32/16 or bfloat16")
    if n >= 2**31 - 1:
        raise ValueError(f"retrieval_topk: ({b}, {n}) scores; the kernel takes at most "
                         "2^31 - 2 columns")
    _check("scores", scores, scores.dtype, (b, n), dev)
    out = torch.empty((2, b, k), dtype=torch.int32, device=dev)  # one allocation, two outputs
    out_ids, out_s = out[0], out[1].view(torch.float32)
    if b:
        parts = retrieval_plan(b, n, k, retrieval_slots(dev, scores.dtype, k))
        stream = _stream(dev)
        arrivals, scratch = _retrieval_buffers(dev, stream, b, parts, k)
        args = (scores.data_ptr(), _RETRIEVAL_DTYPES[scores.dtype], b, n, k, parts,
                scratch.data_ptr(), arrivals.data_ptr(), out_ids.data_ptr(), out_s.data_ptr(),
                stream)
        fn = _fn("retrieval_topk", "knn_retrieval_topk")
        if dev.index == torch.cuda.current_device():
            code = fn(*args)
        else:
            with torch.cuda.device(dev):
                code = fn(*args)
        _launched("retrieval_topk", code)
    return out_ids, out_s.to(scores.dtype)


# ----------------------------------------------------------------------
# K6 flash_attention
# ----------------------------------------------------------------------

# the head dims K6 takes (every model configuration of the repo: 8, 16 and 32
# in the smoke and example configs, 64 and 128 in the full ones)
ATTN_HEAD_DIMS = (8, 16, 32, 64, 128)
# the head dim of the tensor-core route
ATTN_WGMMA_HEAD_DIM = 128


def flash_attention_route(dtype: torch.dtype, head_dim: int) -> tuple[str, int]:
    """The kernel K6 launches for this dtype and head dim, and its route code
    in the C entry point.

    bfloat16 at D = 128 goes to ``"wgmma"`` (code 1), the tensor cores fed by
    TMA. float32 at every D (code 0), and bfloat16 at D < 128 (code 2), go to
    ``"fma"``, float32 FMAs on the CUDA cores: the tensor cores take float32
    only as TF32, whose 10-bit mantissa breaks the float32 tolerance, and the
    wgmma kernel's tiles are 128 columns wide. Any other dtype, or a head dim
    outside ``ATTN_HEAD_DIMS``, raises. No route gives way to another.
    """
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: dtype {dtype}, expected float32 or bfloat16")
    if head_dim not in ATTN_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {head_dim}, the kernel takes "
                         f"{ATTN_HEAD_DIMS}")
    if dtype == torch.float32:
        return "fma", 0
    return ("wgmma", 1) if head_dim == ATTN_WGMMA_HEAD_DIM else ("fma", 2)


@_entry(lambda a: torch.empty_like(a["q"]),
        flops=lambda a: (4 * a["q"].numel() * a["k"].shape[1], a["q"].dtype))
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                    use_kernel: bool = True) -> torch.Tensor:
    """Attention forward: q (B, S, H, D), k and v (B, T, Hkv, D) -> (B, S, H, D).

    Softmax over q.k / sqrt(D), grouped-query (query head h reads kv head
    h // (H / Hkv), K and V never repeated), causal on absolute positions
    (column j <= row i) when asked; a row with every column masked gives 0.
    float32 or bfloat16 in, q's type out; scores, softmax statistics and the
    accumulator in float32, p rounded to v's type before the PV product.

    CUDA kernel: ``csrc/flash_attention.cu`` (replaces ``flash_attention_pallas``),
    one of two by dtype and head dim (``flash_attention_route``). bfloat16 at
    D = 128: one block per (b, h, 128 query rows), a loader warp bringing Q
    and 128-row K and V tiles by TMA into a three-stage ring, two warpgroups
    doing both products with ``wgmma``. float32, and bfloat16 at D < 128: one
    block per (b, h, 64 query rows), float32 FMAs on 64-row kv tiles. Both
    keep the running max, sum and accumulator in registers; any S and T, no
    padding; D in ``ATTN_HEAD_DIMS``. Bound by operations:
    4*B*H*S*T*D flops (half of it under the causal mask) against the bf16
    tensor-core rate.
    """
    if not (q.is_cuda and use_kernel):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    dev = q.device
    b, s, h, d = q.shape
    if k.ndim != 4 or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    t, hkv = k.shape[1], k.shape[2]
    route, code = flash_attention_route(q.dtype, d)
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: {h} query heads are not a multiple of {hkv} kv heads")
    _check("q", q, q.dtype, (b, s, h, d), dev)
    _check("k", k, q.dtype, (b, t, hkv, d), dev)
    _check("v", v, q.dtype, (b, t, hkv, d), dev)
    if route == "wgmma" and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: TMA reads q, k and v from 16-byte aligned addresses")
    out = torch.empty_like(q)
    if b and s and h:
        with torch.cuda.device(dev):
            rc = _fn("flash_attention", "knn_flash_attention")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                code, b, s, t, h, hkv, d, int(causal), d**-0.5, _stream(dev),
            )
        _launched("flash_attention", rc)
    return out


# ----------------------------------------------------------------------
# plain tensor code around the kernels
# ----------------------------------------------------------------------


def serve_gather(vk_ids, vk_d, queries: torch.Tensor, ks: torch.Tensor):
    """Batched kNN query: one row gather + per-query k mask (Theorem 4.3).

    vk_* (n+1, k) tables, queries (B,) int32/int64 vertices, ks (B,) int32
    result counts <= k. Columns at positions >= ks[b] are masked to the pad
    sentinel (-1, +inf), so one (B, k) gather serves heterogeneous-k traffic.
    """
    q = queries.long()
    ids = vk_ids[q]
    d = vk_d[q]
    mask = torch.arange(ids.shape[1], device=ids.device)[None, :] < ks[:, None]
    return torch.where(mask, ids, -1), torch.where(mask & (ids >= 0), d, _INF)


def member(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``torch.isin(x, ids)`` with no host sync: one sort of ``ids`` and a
    ``searchsorted``. ``torch.isin`` takes a ``torch.unique`` past a few dozen
    ids, whose output size the host reads back (a sync the sanitizer's guard
    rejects on the card); a flush deletes hundreds."""
    srt = torch.sort(ids.reshape(-1)).values
    if srt.numel() == 0:
        return torch.zeros_like(x, dtype=torch.bool)
    pos = torch.searchsorted(srt, x.contiguous()).clamp_(max=srt.numel() - 1)
    return srt[pos] == x


def rows_containing(vk_ids: torch.Tensor, obj_ids: torch.Tensor) -> torch.Tensor:
    """(n,) bool: which index rows hold any of ``obj_ids`` (dummy row excluded).

    The vectorized checkDel membership scan. ``member`` sorts the deleted ids
    once instead of materialising the (n, k, D) comparison.
    """
    return member(vk_ids[:-1], obj_ids).any(dim=1)


def _merge_into(vk_ids, vk_d, rows, cat_ids, cat_d, k, use_kernel):
    cat_d = torch.where(cat_ids < 0, _INF, cat_d)
    m_ids, m_d = topk_merge(cat_ids.contiguous(), cat_d.contiguous(), k, use_kernel=use_kernel)
    idx = rows.long()
    vk_ids[idx] = m_ids
    vk_d[idx] = m_d
    return vk_ids, vk_d


def rows_merge(vk_ids, vk_d, rows, cand_ids, cand_d, k: int, *, use_kernel: bool = True):
    """Batched row repair: merge per-row candidates into the live tables.

    Gathers ``rows`` (R,) out of the tables, appends ``cand_*`` (R, P), reruns
    the dedup top-k merge and stores the rows back IN PLACE (the caller owns
    the tables; a published epoch is cloned before it gets here). Padded rows
    name the dummy row n and carry all-pad candidates.
    """
    idx = rows.long()
    cat_ids = torch.cat([vk_ids[idx], cand_ids], dim=1)
    cat_d = torch.cat([vk_d[idx], cand_d.to(vk_d.dtype)], dim=1)
    return _merge_into(vk_ids, vk_d, rows, cat_ids, cat_d, k, use_kernel)


def _purged(vk_ids, vk_d, rows, del_ids):
    idx = rows.long()
    own_ids = vk_ids[idx]
    own_d = vk_d[idx]
    hit = member(own_ids, del_ids)
    return torch.where(hit, -1, own_ids), torch.where(hit, _INF, own_d)


def rows_purge(vk_ids, vk_d, rows, del_ids, k: int, *, use_kernel: bool = True):
    """Batched row purge, in place: drop ``del_ids`` entries and recompact the
    rows (Algorithm 5's removal phase, vectorized over the batch)."""
    pid, pd = _purged(vk_ids, vk_d, rows, del_ids)
    return _merge_into(vk_ids, vk_d, rows, pid, pd, k, use_kernel)


def rows_purge_merge(
    vk_ids, vk_d, rows, del_ids, cand_ids, cand_d, k: int, *, use_kernel: bool = True
):
    """Fused batched move repair, in place: purge + candidate merge in one pass.

    Each row is gathered once, its entries naming a deleted object become pad
    sentinels, the surviving entries and the new insert candidates run through
    one dedup top-k merge, and the row is stored back. ``rows`` is the union
    of the delete-hit rows and the insert frontier; rows outside one of the
    two sets carry all-pad columns for the other.
    """
    pid, pd = _purged(vk_ids, vk_d, rows, del_ids)
    cat_ids = torch.cat([pid, cand_ids], dim=1)
    cat_d = torch.cat([pd, cand_d.to(vk_d.dtype)], dim=1)
    return _merge_into(vk_ids, vk_d, rows, cat_ids, cat_d, k, use_kernel)


# ----------------------------------------------------------------------
# shard ops: the sharded engine's S row blocks of one padded tensor
#
# ``repro_torch.core.sharded`` keeps the tables as one (S*(R+1), k) tensor:
# shard ``s`` owns rows [s*(R+1), (s+1)*(R+1)), its last row its own dummy
# gather row (-1, +inf). Where the JAX package runs one ``shard_map`` block a
# shard, these ops run every shard in one call: a batch is grouped by owner
# shard into an (S, B) matrix of GLOBAL padded rows (row s = shard s's part,
# -1 = padding), and each shard's row offset localises its part exactly as
# ``shard_local_rows`` does, so a pad reads and writes its own shard's dummy
# row. At S = 1 the tensor is one block and each op is the JAX block op.
# ----------------------------------------------------------------------


def shard_local_rows(block_rows: int, rows: torch.Tensor, row_offset) -> torch.Tensor:
    """Global padded rows -> rows of a shard's block; -1 (padding) -> the
    block's dummy row. ``row_offset`` is the shard's first global row, a
    number or a tensor that broadcasts against ``rows``."""
    return torch.where(rows < 0, block_rows - 1, rows - row_offset)


def shard_rows(block_rows: int, rows: torch.Tensor) -> torch.Tensor:
    """(S, B) global padded rows grouped by owner shard -> (S, B) int64 rows
    of the whole padded tensor (a pad -> its shard's dummy row)."""
    rows = rows.long()
    off = torch.arange(rows.shape[0], device=rows.device)[:, None] * block_rows
    return off + shard_local_rows(block_rows, rows, off)


def shard_gather_rows(vk_ids: torch.Tensor, vk_d: torch.Tensor, rows: torch.Tensor,
                      block_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Every shard's row gather at once: (S, B) grouped rows -> (S, B, k) ids
    and dists; padded slots come back as the pad sentinel (-1, +inf)."""
    idx = shard_rows(block_rows, rows)
    return vk_ids[idx], vk_d[idx]


def shard_rows_containing(vk_ids: torch.Tensor, obj_ids: torch.Tensor,
                          block_rows: int) -> torch.Tensor:
    """(S, R) bool: which rows of each shard's block (its dummy row excluded)
    hold any of ``obj_ids``. Rows past a shard's range width are all-pad and
    never hit."""
    blocks = vk_ids.reshape(-1, block_rows, vk_ids.shape[1])[:, :-1]
    return member(blocks, obj_ids).any(dim=-1)


def shard_rows_purge_merge(
    vk_ids: torch.Tensor,    # (S*(R+1), k) int32 padded table, written in place
    vk_d: torch.Tensor,      # (S*(R+1), k) float32
    rows: torch.Tensor,      # (S, B) int32 GLOBAL padded rows by owner shard, -1 pad
    block_rows: int,         # R + 1
    del_ids: torch.Tensor,   # (D,) int32 deleted object ids
    cand_ids: torch.Tensor,  # (S, B, P) int32 new candidates per row, -1 = padding
    cand_d: torch.Tensor,    # (S, B, P) float32
    k: int,
    *,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Every shard's ``rows_purge_merge`` in one K1 launch, in place, plus the
    (S, B) changed mask the repair rounds narrow their frontier with.

    Each row's entries naming a deleted object become pad sentinels, the rest
    and its candidates go through one ``topk_merge``, and the row is stored
    back. Object ids in the table are vertex ids, so the purge needs no
    localisation, only the rows do. A pad slot merges its shard's dummy row
    with all-pad candidates and stores (-1, +inf) back.
    """
    s, b = rows.shape
    idx = shard_rows(block_rows, rows).reshape(-1)
    pid, pd = _purged(vk_ids, vk_d, idx, del_ids)
    cat_ids = torch.cat([pid, cand_ids.reshape(s * b, -1)], dim=1)
    cat_d = torch.cat([pd, cand_d.reshape(s * b, -1).to(vk_d.dtype)], dim=1)
    cat_d = torch.where(cat_ids < 0, _INF, cat_d)
    m_ids, m_d = topk_merge(cat_ids.contiguous(), cat_d.contiguous(), k, use_kernel=use_kernel)
    changed = ((m_ids != vk_ids[idx]) | (m_d != vk_d[idx])).any(dim=1)
    vk_ids[idx] = m_ids
    vk_d[idx] = m_d
    return changed.reshape(s, b)


# ----------------------------------------------------------------------
# halo building blocks: the collective rounds of the sharded engine build
# their candidates from a received slab with these, as the JAX package's
# shard_map programs do, so the candidate order and pad semantics are the
# routed path's
# ----------------------------------------------------------------------

_I32_SENTINEL = 2**31 - 1  # sorts past every valid vertex id
_FOLD_BYTES = 1 << 28  # largest (R, c, B) temporary halo_fold_min makes at once


def masked_unique(x: torch.Tensor) -> torch.Tensor:
    """Sorted unique of the non-negative entries of ``x``, -1 padded to the
    length of ``x`` (flattened): exactly ``np.unique`` of the valid entries,
    then pads."""
    flat = torch.where(x < 0, _I32_SENTINEL, x).to(torch.int32).reshape(-1)
    srt = torch.sort(flat).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    keep = first & (srt < _I32_SENTINEL)
    compact = torch.sort(torch.where(keep, srt, _I32_SENTINEL)).values
    return torch.where(compact == _I32_SENTINEL, -1, compact)


def halo_candidates(
    recv_ids: torch.Tensor,  # (M, k) int32 received neighbour rows
    recv_d: torch.Tensor,    # (M, k) float32
    slot: torch.Tensor,      # (B, t) int32 receive-slab row per neighbour (M = miss)
    w: torch.Tensor,         # (B, t) float32 edge weights (pad value irrelevant)
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Received halo rows -> per-receiver (B, t*k) repair candidates,
    neighbour-major and table-column-minor, pads (id < 0, every miss slot
    included) at +inf: the routed host repair's candidates, bit for bit (one
    float32 add either way)."""
    b, t = slot.shape
    m = recv_ids.shape[0]
    safe = torch.clamp(slot.long(), max=m - 1)
    hit = (slot < m)[..., None]
    g_ids = torch.where(hit, recv_ids[safe], -1)          # (B, t, k)
    g_d = w[..., None] + recv_d[safe]
    cand_ids = g_ids.reshape(b, t * k)
    cand_d = torch.where(cand_ids < 0, _INF, g_d.reshape(b, t * k))
    return cand_ids, cand_d.to(torch.float32)


def halo_fold_min(
    recv: torch.Tensor,  # (M, B) float32 received gated send rows
    slot: torch.Tensor,  # (R, t) int32 receive-slab row per neighbour (M = miss)
    w: torch.Tensor,     # (R, t) float32 edge weights
) -> torch.Tensor:
    """Received frontier send rows -> per-receiver (R, B) min over neighbours
    of (weight + row), a few neighbour columns at a time; miss slots read
    +inf. Each candidate is one float32 add and min is order-free, so the
    values are the routed fold's and the scalar round's."""
    r, t = slot.shape
    m, b = recv.shape
    cand = torch.full((r, b), _INF, dtype=torch.float32, device=recv.device)
    # neighbour columns a few at a time, (R, c, B) of at most _FOLD_BYTES
    step = max(1, _FOLD_BYTES // max(1, r * b * 4))
    for j in range(0, t, step):
        sl = slot[:, j:j + step]
        rows = w[:, j:j + step, None] + recv[torch.clamp(sl.long(), max=m - 1)]
        rows = torch.where((sl < m)[..., None], rows, _INF)
        torch.minimum(cand, rows.amin(dim=1), out=cand)
    return cand
