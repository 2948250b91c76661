"""Device-resident level-synchronous construction of the KNN-Index (Alg. 3).

The paper's bidirectional construction processes vertices one at a time in
rank order. The only true dependency is through BNS^< (bottom-up sweep) or
BNS^> (top-down sweep), so vertices sharing a DAG level are independent and
are processed as one device step:

    gather neighbour rows -> shift by edge weight -> dedup top-k merge -> scatter

* ``prepare_sweep`` packs every level's ``verts``/``nbr``/``w`` into a small
  number of flat, contiguous device arrays, one set per neighbour-width bucket
  (power-of-4 widths capped at the global max), a level's rows next to each
  other, and records where each level's rows start. The whole schedule is
  uploaded once per sweep; nothing else crosses the host/device boundary
  until the result is read. No row is padding: a launch covers exactly its
  level's rows, so the fixed row chunks of the JAX package's layout (there to
  bound the number of compiled shapes) have no counterpart here.

* ``run_sweep`` walks the levels in order and launches ``ops.sweep_merge``
  ONCE PER LEVEL over that level's contiguous row range, in place on the live
  tables (the level invariant makes that safe). The true dependency is the
  level. A road network has hundreds of small levels per direction, so the
  sweep's time is mostly launch overhead, not kernel time.

* ``build_knn_tables`` chains the two sweeps on the device: the bottom-up
  tables (V_k^<, dummy row included) are the top-down sweep's per-vertex
  extra candidates (the paper's computation sharing, section 5.3), with no
  host sync in between.

Value-equivalence with the sequential reference is exact (tested): a level
only ever reads rows written by strictly earlier levels, the same partial
order the paper's total rank refines.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bngraph import BNGraph
from repro_torch.core.index import KNNIndex
from repro_torch.kernels import ops

_INF = np.float32(np.inf)


def resolve_device(device) -> torch.device:
    """The torch device of an entry point; a CUDA device must be present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but no CUDA device is available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def _t_bucket(t_true: int, cap: int) -> int:
    """Power-of-4 neighbour-width bucket (lo 4), capped at the global width."""
    p = 4
    while p < t_true:
        p *= 4
    return min(p, cap)


@dataclasses.dataclass(frozen=True)
class SweepBucket:
    """Flat device-resident schedule arrays for one neighbour-width bucket."""

    t_pad: int
    verts: torch.Tensor  # (R,) int32 target rows, level after level
    nbr: torch.Tensor    # (R, t_pad) int32, padded slots hold -1
    w: torch.Tensor      # (R, t_pad) float32, padded slots hold +inf


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """One direction of the construction, uploaded once and replayed on device."""

    n: int
    direction: str
    buckets: tuple[SweepBucket, ...]
    level_bucket: tuple[int, ...]  # bucket index of each level
    level_off: tuple[int, ...]     # first row of each level in its bucket
    level_sizes: tuple[int, ...]
    occupancy: float               # true neighbour cells / cells of the flat layout
    occupancy_levelwise: float     # same under per-level pow2 padding of rows and width

    @property
    def num_levels(self) -> int:
        return len(self.level_sizes)

    def bucket_signature(self) -> tuple[int, ...]:
        """The neighbour widths T of the flat layout, in first-use order."""
        return tuple(b.t_pad for b in self.buckets)


def _next_pow2(x: int, lo: int = 8) -> int:
    return max(lo, 1 << (max(1, x) - 1).bit_length())


def prepare_sweep(bn: BNGraph, direction: str, *, device="cuda") -> SweepPlan:
    """Extract one direction's schedule and upload it to the device, once."""
    dev = resolve_device(device)
    _, ids_tab, w_tab = bn.sweep_tables(direction)
    n = bn.n
    deg = (ids_tab >= 0).sum(axis=1)
    cap = _next_pow2(int(deg.max()), lo=4) if n else 4

    levels = bn.level_members(direction)
    members: dict[int, list[np.ndarray]] = {}  # T -> its levels' vertices, in level order
    filled: dict[int, int] = {}                # T -> rows so far
    level_bucket: list[int] = []
    level_off: list[int] = []
    true_cells = 0
    flat_cells = 0
    levelwise_cells = 0
    for vs in levels:
        t_true = int(deg[vs].max())
        t_pad = _t_bucket(t_true, cap)
        members.setdefault(t_pad, []).append(vs)
        level_bucket.append(list(members).index(t_pad))
        level_off.append(filled.get(t_pad, 0))
        filled[t_pad] = level_off[-1] + len(vs)
        true_cells += int(deg[vs].sum())
        flat_cells += len(vs) * t_pad
        levelwise_cells += _next_pow2(len(vs)) * (_next_pow2(t_true, lo=1) if t_true else 1)

    buckets = []
    for t_pad, parts in members.items():
        verts = np.concatenate(parts).astype(np.int32)
        t_copy = min(t_pad, ids_tab.shape[1])
        nbr = np.full((verts.size, t_pad), -1, np.int32)
        w = np.full((verts.size, t_pad), _INF, np.float32)
        nbr[:, :t_copy] = ids_tab[verts, :t_copy]
        w[:, :t_copy] = w_tab[verts, :t_copy]
        w[nbr < 0] = _INF
        buckets.append(
            SweepBucket(
                t_pad=t_pad,
                verts=torch.from_numpy(verts).to(dev),
                nbr=torch.from_numpy(nbr).to(dev),
                w=torch.from_numpy(w).to(dev),
            )
        )
    return SweepPlan(
        n=n,
        direction=direction,
        buckets=tuple(buckets),
        level_bucket=tuple(level_bucket),
        level_off=tuple(level_off),
        level_sizes=tuple(len(vs) for vs in levels),
        occupancy=true_cells / max(1, flat_cells),
        occupancy_levelwise=true_cells / max(1, levelwise_cells),
    )


def run_sweep(
    plan: SweepPlan,
    extra_ids: torch.Tensor,  # (n+1, E) int32 per-vertex extra candidates, on device
    extra_d: torch.Tensor,    # (n+1, E) float32, on device
    k: int,
    *,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run one direction of the construction. Returns device (n+1, k) tables.

    extra_* supply the non-neighbour candidate terms of Lemmas 5.12/5.21:
    bottom-up, the vertex itself when it is an object; top-down, the vertex's
    own V_k^< row. Both are (n+1)-row device tables (dummy row last), gathered
    on device, so the loop below only enqueues launches.
    """
    dev = extra_ids.device
    vk_ids = torch.full((plan.n + 1, k), -1, dtype=torch.int32, device=dev)
    vk_d = torch.full((plan.n + 1, k), float("inf"), dtype=torch.float32, device=dev)
    for bid, off, size in zip(plan.level_bucket, plan.level_off, plan.level_sizes):
        b = plan.buckets[bid]
        ops.sweep_merge(
            b.nbr[off : off + size], b.verts[off : off + size], b.w[off : off + size],
            extra_ids, extra_d, vk_ids, vk_d, k, inplace=True, use_kernel=use_kernel,
        )
    return vk_ids, vk_d


def object_extras(n: int, objects: np.ndarray, k: int, *, device="cuda"):
    """Bottom-up extras: each object is a distance-0 candidate for itself.

    Padded to E = k columns so both sweeps see the same extra shapes.
    """
    dev = resolve_device(device)
    is_obj = np.zeros(n, dtype=bool)
    is_obj[objects] = True
    ex_ids = np.full((n + 1, k), -1, np.int32)
    ex_ids[:n, 0] = np.where(is_obj, np.arange(n, dtype=np.int32), -1)
    ex_d = np.full((n + 1, k), _INF, np.float32)
    ex_d[:n, 0] = np.where(is_obj, np.float32(0), _INF)
    return torch.from_numpy(ex_ids).to(dev), torch.from_numpy(ex_d).to(dev)


def build_knn_tables(
    bn: BNGraph,
    objects: np.ndarray,
    k: int,
    *,
    device="cuda",
    use_kernel: bool = True,
    plans: tuple[SweepPlan, SweepPlan] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 3, device sweeps: V_k^< up, then V_k down, no host sync.

    The bottom-up tables (dummy row included) feed the top-down sweep directly
    as its extra-candidate tables. Returns the live device (n+1, k) int32 /
    float32 tables (dummy row last), the layout ``QueryEngine`` serves from.
    ``plans`` lets a caller that already ran ``prepare_sweep`` (to report
    schedule stats, say) reuse the uploaded (up, down) schedules.
    """
    dev = resolve_device(device)
    ex_ids, ex_d = object_extras(bn.n, objects, k, device=dev)
    plan_up, plan_down = plans or (
        prepare_sweep(bn, "up", device=dev),
        prepare_sweep(bn, "down", device=dev),
    )
    # bottom-up: V_k^< (Lemma 5.12)
    vkl_ids, vkl_d = run_sweep(plan_up, ex_ids, ex_d, k, use_kernel=use_kernel)
    # top-down: V_k (Lemma 5.21), extras = own V_k^< rows, still on device
    return run_sweep(plan_down, vkl_ids, vkl_d, k, use_kernel=use_kernel)


def tables_to_index(vk_ids: torch.Tensor, vk_d: torch.Tensor, n: int, k: int) -> KNNIndex:
    """Read device tables back into the host ``KNNIndex`` view (oracle dtype)."""
    # the index owns writable host buffers: core/updates.py patches rows in place
    ids = vk_ids[:n].cpu().numpy().copy()
    dists = np.where(ids >= 0, vk_d[:n].cpu().numpy().astype(np.float64), np.inf)
    return KNNIndex(ids=ids, dists=dists, k=k)


def build_knn_index(
    bn: BNGraph, objects: np.ndarray, k: int, *, device="cuda", use_kernel: bool = True
) -> KNNIndex:
    """Device construction + readback into the host ``KNNIndex`` view."""
    vk_ids, vk_d = build_knn_tables(bn, objects, k, device=device, use_kernel=use_kernel)
    return tables_to_index(vk_ids, vk_d, bn.n, k)


def batched_query(vk_ids: torch.Tensor, vk_d: torch.Tensor, queries: torch.Tensor):
    """Device-side batched kNN query: pure row gather (Theorem 4.3, O(k))."""
    q = queries.long()
    return vk_ids[q], vk_d[q]
