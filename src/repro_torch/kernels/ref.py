"""Plain PyTorch versions of the six kernels (the equality targets).

These run on any device. The CPU tests use them, the wrappers in ``ops.py``
use them for CPU tensors, and the on-card check compares each CUDA kernel
with its function here on the same inputs. The four kNN kernels follow
``kround_merge`` and the ``*_ref`` oracles of the JAX package: exact, no
summation order to differ in (one float32 add, then mins). ``retrieval_topk``
follows the JAX package's kernel path (exact too), and
``retrieval_topk_parts_ref`` mirrors how K5 gets there; ``flash_attention`` sums
in another order than any kernel, so it is held to a tolerance.
"""
from __future__ import annotations

import torch

_INT_MAX = torch.iinfo(torch.int32).max
_INF = float("inf")
# largest (rows, t, N) temporary minplus_matmul_ref materialises at once
_MINPLUS_TEMP_BYTES = 1 << 30
# K4's slices: output tiles of MINPLUS_TILE rows x MINPLUS_TILE columns,
# t walked MINPLUS_DEPTH at a time (csrc/minplus.cu's BM = BN and BK)
MINPLUS_TILE = 128
MINPLUS_DEPTH = 32
# the two bits of a slice: every entry +inf; a NaN or a -inf in it
SLICE_ALL_PINF = 1
SLICE_POISON = 2
# largest (rows, N) sort retrieval_topk_ref runs at once (values + indices)
_TOPK_TEMP_BYTES = 1 << 30
# retrieval_keys' "no candidate" (K5's key 0), below every other key
_NO_KEY = torch.iinfo(torch.int64).min
# query rows per block of flash_attention_ref, and its kv rows by default
_ATTN_BLOCK = 1024


def kround_merge(cand_ids: torch.Tensor, cand_d: torch.Tensor, k: int):
    """k rounds of dedup min-selection over (B, C) candidates.

    Per row: the k smallest-distance distinct ids, distance ties to the
    smaller id, exhausted slots (-1, +inf). ``cand_d`` must be float32 and
    already +inf wherever ``cand_ids < 0``.
    """
    b, c = cand_ids.shape
    out_ids = torch.full((b, k), -1, dtype=torch.int32, device=cand_ids.device)
    out_d = torch.full((b, k), _INF, dtype=torch.float32, device=cand_ids.device)
    if c == 0 or b == 0:
        return out_ids, out_d
    cd = cand_d
    for i in range(k):
        dmin = cd.min(dim=1).values
        tied = torch.where(cd == dmin[:, None], cand_ids, _INT_MAX)
        idmin = tied.min(dim=1).values
        ok = torch.isfinite(dmin)
        out_ids[:, i] = torch.where(ok, idmin, -1)
        out_d[:, i] = torch.where(ok, dmin, _INF)
        # drop every candidate carrying the selected id: dedup for free
        cd = torch.where(cand_ids == idmin[:, None], _INF, cd)
    return out_ids, out_d


def topk_merge_ref(cand_ids: torch.Tensor, cand_d: torch.Tensor, k: int):
    """k smallest-distance distinct ids per row; ties broken by smaller id.

    ``cand_ids`` (B, C) int32 with -1 = invalid, ``cand_d`` (B, C) float32 or
    float16 (math in float32, output in the input type). ``C < k`` works: the
    missing slots come out as (-1, +inf).
    """
    d = torch.where(cand_ids < 0, _INF, cand_d.to(torch.float32))
    out_ids, out_d = kround_merge(cand_ids, d, k)
    return out_ids, out_d.to(cand_d.dtype)


def sweep_candidates(nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d):
    """The explicit (S, T*k+E) candidate tensors of one sweep step."""
    s, t = nbr.shape
    k = vk_ids.shape[1]
    n1 = vk_ids.shape[0]
    valid = nbr >= 0
    nbr_c = torch.where(valid, nbr, n1 - 1).long()
    g_ids = torch.where(valid[..., None], vk_ids[nbr_c], -1)
    g_d = w[..., None] + vk_d[nbr_c]
    rows = verts.long()
    cand_ids = torch.cat([g_ids.reshape(s, t * k), ex_ids[rows]], dim=1)
    cand_d = torch.cat([g_d.reshape(s, t * k), ex_d[rows]], dim=1).to(torch.float32)
    return cand_ids, torch.where(cand_ids < 0, _INF, cand_d)


def sweep_merge_ref(nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d, k: int):
    """Merged (S, k) rows of one sweep step, as an explicit candidate tensor.

    gather neighbour k-lists -> shift by edge weight -> append extras -> dedup
    top-k. Row i is the new content of table row ``verts[i]``; the tables are
    not written (see ``ops.sweep_merge`` for the scatter).

    nbr (S, T) int32 with -1 pads, verts (S,) int32 with n = dummy row,
    w (S, T) float32, ex_* (n+1, E), vk_* (n+1, k).
    """
    cand_ids, cand_d = sweep_candidates(nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d)
    return kround_merge(cand_ids, cand_d, k)


def frontier_relax_ref(nbr, rows, w, dist, kth, src):
    """New (R, B) receiver rows of one pruned-relaxation (checkIns) round.

    For receiver row v = rows[i] and source column c:
        new[i, c] = min(dist[v, c], min over u in nbr[i], gate(u, c) of
                                        w[i, j] + dist[u, c])
        gate(u, c) = dist[u, c] < kth[u]  or  u == src[c]
    Pure Jacobi: ``dist`` is only read. One neighbour column at a time, so
    only (R, B) intermediates exist.

    nbr (R, T) int32 with -1 pads, rows (R,) int32 with n = dummy row,
    w (R, T) float32, dist (n+1, B) float32, kth (n+1,) float32,
    src (B,) int32 with -1 pads.
    """
    n1 = dist.shape[0]
    acc = dist[rows.long()]
    for j in range(nbr.shape[1]):
        nv = nbr[:, j]
        valid = nv >= 0
        nc = torch.where(valid, nv, n1 - 1)
        ncl = nc.long()
        nd = dist[ncl]
        gate = (nd < kth[ncl][:, None]) | (nc[:, None] == src[None, :])
        cand = w[:, j, None] + nd
        acc = torch.minimum(acc, torch.where(valid[:, None] & gate, cand, _INF))
    return acc


def frontier_relax_rows_ref(nbr_tab, w_tab, rows, dist, kth, src):
    """The engine's frontier round: ``frontier_relax_ref`` on the receivers'
    rows of the (n+1, T) bucket tables, and the (R,) changed mask
    ``(new < old).any(1)`` (distances only ever decrease, so "below" is
    "changed"). Returns (tile, changed); ``dist`` is only read."""
    idx = rows.long()
    tile = frontier_relax_ref(nbr_tab[idx], rows, w_tab[idx], dist, kth, src)
    return tile, (tile < dist[idx]).any(dim=1)


def minplus_matmul_ref(a: torch.Tensor, b: torch.Tensor):
    """Tropical (min, +) product ``C[i, j] = min_t a[i, t] + b[t, j]``.

    Math in float32, output in ``a``'s type; +inf is inert and NaN propagates
    (``amin`` / ``minimum``), as in the JAX package's ``minplus_matmul_ref``.
    That one materialises the whole (M, K, N) sum; this one walks row and t
    chunks so that the (rows, t, N) temporary stays under 1 GiB (the
    certificate squares a 19,881-wide matrix), and takes the same
    values: each term is one float32 add and min has no order to differ in.
    """
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    m, kd = af.shape
    if bf.ndim != 2 or bf.shape[0] != kd:
        raise ValueError(f"minplus: shapes {tuple(a.shape)} and {tuple(b.shape)} do not chain")
    n = bf.shape[1]
    out = torch.full((m, n), _INF, dtype=torch.float32, device=af.device)
    if m and n and kd:
        t_step = max(1, min(kd, _MINPLUS_TEMP_BYTES // (4 * n)))
        r_step = max(1, _MINPLUS_TEMP_BYTES // (4 * n * t_step))
        for t0 in range(0, kd, t_step):
            bt = bf[t0 : t0 + t_step][None]
            for r0 in range(0, m, r_step):
                part = torch.amin(af[r0 : r0 + r_step, t0 : t0 + t_step, None] + bt, dim=1)
                rows = out[r0 : r0 + r_step]
                torch.minimum(rows, part, out=rows)
    return out.to(a.dtype)


def minplus_slice_bits(a: torch.Tensor, b: torch.Tensor, tile: int = MINPLUS_TILE,
                       depth: int = MINPLUS_DEPTH):
    """The slice bits K4's first kernel computes, as uint8 tensors:
    A's (ceil(M/tile), ceil(K/depth)) for tile-row x depth-t slices and B's
    (ceil(K/depth), ceil(N/tile)) for depth-t x tile-column slices, each
    ``SLICE_ALL_PINF`` if every entry is +inf, ``| SLICE_POISON`` if one is NaN
    or -inf. Entries past the edges count as +inf."""
    inf = torch.tensor(_INF, dtype=torch.float32, device=a.device)

    def bits(x, sr, sc):
        r, c = x.shape
        xp = torch.full((-(-r // sr) * sr, -(-c // sc) * sc), _INF, dtype=torch.float32,
                        device=x.device)
        xp[:r, :c] = x
        blocks = xp.reshape(xp.shape[0] // sr, sr, xp.shape[1] // sc, sc)
        pinf = (blocks == inf).all(dim=3).all(dim=1)
        poison = (torch.isnan(blocks) | (blocks == -inf)).any(dim=3).any(dim=1)
        return pinf.to(torch.uint8) * SLICE_ALL_PINF | poison.to(torch.uint8) * SLICE_POISON

    return bits(a.to(torch.float32), tile, depth), bits(b.to(torch.float32), depth, tile)


def minplus_live_counts(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """(row blocks, column blocks) int64: how many t slices of each output tile
    pair a live A slice with a live B slice. A pair is inert iff
    (all_pinf(A) and not poison(B)) or (all_pinf(B) and not poison(A)); since
    all_pinf excludes poison, the count of inert slices is
    sum_t Ap (1 - Bq) + (1 - Aq) Bp - Ap Bp, three 0/1 products (exact in
    float32 up to 2^24 slices)."""
    ap, aq = ((a_bits & m).to(torch.float32) / m for m in (SLICE_ALL_PINF, SLICE_POISON))
    bp, bq = ((b_bits & m).to(torch.float32) / m for m in (SLICE_ALL_PINF, SLICE_POISON))
    inert = ap @ (1 - bq) + (1 - aq) @ bp - ap @ bp
    return a_bits.shape[1] - inert.round().to(torch.int64)


def retrieval_topk_ref(scores: torch.Tensor, k: int):
    """k largest scores per row and their column indices, best first.

    The JAX package's kernel path, which its own oracle does not match (see
    ``ops.retrieval_topk``): math in float32, equal scores to the smaller
    column, a -inf score gives (-1, -inf), the output is always (B, k) with
    (-1, -inf) past the row's last finite score; NaN reads as -inf and -0.0
    as +0.0. A stable descending sort over chunks of rows, so a (512, 10^6)
    input needs at most a 1 GiB temporary.
    """
    b, n = scores.shape
    dev = scores.device
    out_ids = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    out_s = torch.full((b, k), -_INF, dtype=torch.float32, device=dev)
    kk = min(k, n)
    if b and kk:
        step = max(1, _TOPK_TEMP_BYTES // (12 * n))
        for r0 in range(0, b, step):
            s = scores[r0 : r0 + step].to(torch.float32)
            s = torch.where(torch.isnan(s), -_INF, s) + 0.0
            top, idx = torch.sort(s, dim=1, descending=True, stable=True)
            top, idx = top[:, :kk], idx[:, :kk]
            out_ids[r0 : r0 + step, :kk] = torch.where(top > -_INF, idx.to(torch.int32), -1)
            out_s[r0 : r0 + step, :kk] = top
    return out_ids, out_s.to(scores.dtype)


def retrieval_keys(scores: torch.Tensor) -> torch.Tensor:
    """K5's 64-bit keys of a (B, N) score matrix, as int64 in the same order:
    (order-preserving float32 bits) << 32 | (0xffffffff - column), so a
    larger key is a larger score or the same score at a smaller column;
    NaN and -inf give ``_NO_KEY``, below every other key, -0.0 reads as +0.0."""
    s = scores.to(torch.float32)
    none = torch.isnan(s) | (s == -_INF)
    bits = (s + 0.0).view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    cols = torch.arange(s.shape[1], dtype=torch.int64, device=s.device)
    return torch.where(none, _NO_KEY, (ordered << 32) | (0xFFFFFFFF - cols))


def retrieval_topk_parts_ref(scores: torch.Tensor, k: int, parts: int):
    """``retrieval_topk_ref`` the way K5 computes it, in plain torch: each row
    cut into ``parts`` parts of ceil(N / parts) columns; each part's k best
    keys (``retrieval_keys``) and its k-th key (``_NO_KEY`` if it holds fewer
    than k); theta_lb = the largest k-th key; of the parts' keys only those
    >= theta_lb go on; their k best, sorted. The same answer for every
    ``parts``: the part whose k-th key is theta_lb has k keys >= it."""
    b, n = scores.shape
    keys = retrieval_keys(scores)
    width = max(1, -(-n // parts))
    pad = torch.full((b, k), _NO_KEY, dtype=torch.int64, device=keys.device)
    tops = []
    for p in range(parts):
        seg = torch.cat([keys[:, p * width : (p + 1) * width], pad], dim=1)
        tops.append(torch.topk(seg, k, dim=1).values)  # sorted: column k-1 is the k-th key
    theta_lb = torch.stack([t[:, k - 1] for t in tops], dim=1).amax(dim=1, keepdim=True)
    cand = torch.cat(tops, dim=1)
    cand = torch.where(cand >= theta_lb, cand, _NO_KEY)
    best = torch.topk(torch.cat([cand, pad], dim=1), k, dim=1).values
    found = best != _NO_KEY
    ids = torch.where(found, 0xFFFFFFFF - (best & 0xFFFFFFFF), -1)
    s = scores.to(torch.float32) + 0.0
    top = torch.where(found, s.gather(1, ids.clamp_min(0)), -_INF)
    return ids.to(torch.int32), top.to(scores.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                        kv_block: int = _ATTN_BLOCK):
    """Attention over blocks with an online softmax, as ``nn.chunked_attention``
    and the Pallas kernel compute it: q (B, S, H, D), k and v (B, T, Hkv, D).

    Grouped-query heads by a (Hkv, H/Hkv) view, never by repeating K and V;
    causal on absolute positions; scores, running max, sum and accumulator in
    float32, p rounded to v's type before the PV product, a fully masked row
    0; output in q's type. Blocks of 1024 query rows and ``kv_block`` kv rows
    bound the temporaries, so the kernel's own shapes (S = T = 32,768) fit;
    kv blocks past a query block's last row are skipped under the causal
    mask. p is rounded against the running max over the kv blocks so far, so
    in bfloat16 ``kv_block`` decides the scale each p is rounded at, as
    ``block_k`` does in the Pallas kernel.
    """
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = d**-0.5
    dev = q.device
    out = torch.empty_like(q)
    qg = q.reshape(b, s, hkv, rep, d)
    for q0 in range(0, s, _ATTN_BLOCK):
        qb = qg[:, q0 : q0 + _ATTN_BLOCK].to(torch.float32)
        sq = qb.shape[1]
        q_pos = torch.arange(q0, q0 + sq, device=dev)
        m = torch.full((b, hkv, rep, sq), -_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, rep, sq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, rep, sq, d), dtype=torch.float32, device=dev)
        k_end = min(t, q0 + sq) if causal else t
        for k0 in range(0, k_end, kv_block):
            kb = k[:, k0 : k0 + kv_block].to(torch.float32)
            vb = v[:, k0 : k0 + kv_block]
            sc = torch.einsum("bqgrd,bkgd->bgrqk", qb, kb) * scale
            if causal:
                k_pos = torch.arange(k0, k0 + kb.shape[1], device=dev)
                sc = torch.where(q_pos[:, None] >= k_pos[None, :], sc, -_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.where(torch.isfinite(m_new)[..., None], torch.exp(sc - m_new[..., None]), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bgrqk,bkgd->bgrqd", p.to(v.dtype).to(torch.float32),
                              vb.to(torch.float32))
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, q0 : q0 + sq] = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    return out
