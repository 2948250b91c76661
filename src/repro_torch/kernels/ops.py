"""Public wrappers around the CUDA kernels, and the plain-torch table ops.

Three functions here launch a hand-written kernel (``csrc/*.cu``):
``topk_merge``, ``sweep_merge`` and ``frontier_relax``. Given CUDA tensors and
``use_kernel=True`` (the default) a wrapper checks device, dtype, shape and
contiguity, launches its kernel on the current stream and raises if the launch
is refused; it never gives way to the plain version. Given CPU tensors it
runs the plain version in ``ref.py``, and only because the tensors lie on the
CPU. ``use_kernel=False`` asks for the plain version on whatever device the
tensors are on (the on-card comparison uses that).

Every kernel launch adds one to ``LAUNCHES[name]``; nothing else does.

The remaining functions (``serve_gather``, ``rows_containing``, ``rows_merge``,
``rows_purge``, ``rows_purge_merge``) are plain tensor code around
``topk_merge``, as they were plain array code around it in the JAX package.
Tables stay int32 / float32; indices widen to int64 only at the indexing call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"topk_merge": 0, "sweep_merge": 0, "frontier_relax": 0}

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
    "knn_topk_merge": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "knn_sweep_merge": ([_P] * 9 + [_I] * 8 + [_P], _I),
    "knn_frontier_relax": ([_P] * 7 + [_I] * 4 + [_P], _I),
    "knn_topk_merge_smem": ([_I, _I], ctypes.c_longlong),
    "knn_sweep_merge_smem": ([_I, _I, _I], ctypes.c_longlong),
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


def _threads(work: int, cap: int) -> int:
    """Block size: one thread per work item, whole warps, at most ``cap``."""
    return max(32, min(cap, -(-work // 32) * 32))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ----------------------------------------------------------------------
# K1 topk_merge
# ----------------------------------------------------------------------


def topk_merge(cand_ids: torch.Tensor, cand_d: torch.Tensor, k: int, *, use_kernel: bool = True):
    """Top-k distinct-id merge. cand_ids (B, C) int32 (-1 invalid), cand_d
    (B, C) float32 or float16. Returns ((B, k) int32, (B, k) of cand_d's type).

    CUDA kernel: ``csrc/topk_merge.cu`` (replaces ``topk_merge_pallas``). One
    block per row, no padding of B or C. Bound by bytes: B*C*8 read, B*k*8
    written. float16 distances are widened to float32 here and narrowed back,
    as the TPU kernel's body did.
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
    smem = _fn("topk_merge", "knn_topk_merge_smem")(c, k)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"topk_merge: C={c} candidates need {smem} bytes of shared memory, "
            f"a block may have {MAX_SMEM_BYTES}"
        )
    out_ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b:
        with torch.cuda.device(dev):
            code = _fn("topk_merge", "knn_topk_merge")(
                cand_ids.data_ptr(), cand_d.data_ptr(), out_ids.data_ptr(),
                out_d.data_ptr(), b, c, k, _threads(c, 256), _stream(dev),
            )
        _launched("topk_merge", code)
    return out_ids, out_d.to(out_dtype)


# ----------------------------------------------------------------------
# K2 sweep_merge
# ----------------------------------------------------------------------


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
    inplace: bool,
    use_kernel: bool = True,
    max_smem_bytes: int = MAX_SMEM_BYTES,
):
    """Fused sweep step: gather + shift + dedup top-k (+ scatter).

    ``inplace=True`` stores the merged rows at rows ``verts`` of the live
    tables and returns them. That is the construction sweeps' form and is only
    right under the level invariant: a call's neighbour rows and target rows
    are disjoint. Padded rows (``verts == n``) are not stored, so the dummy
    row stays (-1, +inf).

    ``inplace=False`` leaves the tables untouched and returns the merged rows
    as fresh (S, k) tiles, row i for ``verts[i]``. The engine's repair rounds
    use this form: repaired rows read each other, so they must all read the
    pre-round tables, and the caller scatters after it has compared.

    CUDA kernel: ``csrc/sweep_merge.cu`` (replaces ``sweep_merge_pallas``).
    One block per target row, candidates only ever in shared memory. Bound by
    bytes: S*T*8 of schedule, the distinct neighbour rows and S extras rows
    read, S*k*8 written. When T*k+E candidates exceed ``max_smem_bytes`` the
    block walks the neighbours in groups, carrying its running k best.
    """
    if not (vk_ids.is_cuda and use_kernel):
        m_ids, m_d = ref.sweep_merge_ref(nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d, k)
        if not inplace:
            return m_ids, m_d
        keep = verts != vk_ids.shape[0] - 1
        rows = verts[keep].long()
        vk_ids[rows] = m_ids[keep]
        vk_d[rows] = m_d[keep]
        return vk_ids, vk_d
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
    smem_of = _fn("sweep_merge", "knn_sweep_merge_smem")
    t_group = max(1, t)
    if smem_of(t_group, k, e) > max_smem_bytes:
        fixed = smem_of(0, k, e)
        t_group = (max_smem_bytes - fixed) // (k * 8)
        if t_group < 1:
            raise ValueError(
                f"sweep_merge: k={k}, E={e} do not fit {max_smem_bytes} bytes of shared memory"
            )
    if inplace:
        out_ids, out_d = vk_ids, vk_d
    else:
        out_ids = torch.empty((s, k), dtype=torch.int32, device=dev)
        out_d = torch.empty((s, k), dtype=torch.float32, device=dev)
    if s:
        with torch.cuda.device(dev):
            code = _fn("sweep_merge", "knn_sweep_merge")(
                nbr.data_ptr(), verts.data_ptr(), w.data_ptr(),
                ex_ids.data_ptr(), ex_d.data_ptr(), vk_ids.data_ptr(), vk_d.data_ptr(),
                out_ids.data_ptr(), out_d.data_ptr(),
                s, t, k, e, n1 - 1, t_group, 0 if inplace else 1,
                _threads(min(t, t_group) * k + e, 256), _stream(dev),
            )
        _launched("sweep_merge", code)
    return out_ids, out_d


# ----------------------------------------------------------------------
# K3 frontier_relax
# ----------------------------------------------------------------------


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
    receiver set. The caller derives the changed mask and scatters the tile.

    CUDA kernel: ``csrc/frontier_relax.cu`` (replaces ``frontier_relax_pallas``).
    One block per receiver row, threads along the B columns. Bound by bytes:
    R*T*8 of schedule, the distinct neighbour rows and R own rows (B*4 each)
    read, R*B*4 written.
    """
    if not (dist.is_cuda and use_kernel):
        return ref.frontier_relax_ref(nbr, rows, w, dist, kth, src)
    dev = dist.device
    r, t = nbr.shape
    n1, b = dist.shape
    _check("nbr", nbr, torch.int32, (r, t), dev)
    _check("rows", rows, torch.int32, (r,), dev)
    _check("w", w, torch.float32, (r, t), dev)
    _check("dist", dist, torch.float32, (n1, b), dev)
    _check("kth", kth, torch.float32, (n1,), dev)
    _check("src", src, torch.int32, (b,), dev)
    out = torch.empty((r, b), dtype=torch.float32, device=dev)
    if r and b:
        with torch.cuda.device(dev):
            code = _fn("frontier_relax", "knn_frontier_relax")(
                nbr.data_ptr(), rows.data_ptr(), w.data_ptr(), dist.data_ptr(),
                kth.data_ptr(), src.data_ptr(), out.data_ptr(),
                r, t, b, _threads(b, 256), _stream(dev),
            )
        _launched("frontier_relax", code)
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


def rows_containing(vk_ids: torch.Tensor, obj_ids: torch.Tensor) -> torch.Tensor:
    """(n,) bool: which index rows hold any of ``obj_ids`` (dummy row excluded).

    The vectorized checkDel membership scan. ``torch.isin`` sorts the deleted
    ids once instead of materialising the (n, k, D) comparison.
    """
    return torch.isin(vk_ids[:-1], obj_ids).any(dim=1)


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
    hit = torch.isin(own_ids, del_ids)
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
