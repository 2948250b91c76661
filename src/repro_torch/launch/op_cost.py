"""The op-level count of a step's work: the port of ``repro/launch/hlo_cost.py``
(and of the collective accounting of ``repro/launch/hlo_analysis.py``).

The JAX package parses the compiled HLO of a step: dot FLOPs, and bytes at
fusion boundaries, with each while loop's body multiplied by its trip count,
since XLA's own ``cost_analysis`` counts a loop body once. Here a step is
Python over torch ops, and ``count()`` watches every aten op it dispatches
(a ``TorchDispatchMode``, below autograd, so a backward's ops are counted
where they run):

  flops   matmul FLOPs by dtype, from ``torch.utils.flop_counter``'s formulas
          (2 * M * N * K for a matmul; the counterpart of hlo_cost's dot-only
          count). Elementwise work, reductions and sorts are not counted, as
          hlo_cost does not count them.
  bytes   each op's tensor operands once and its results once; views and
          allocations (``view``, ``_unsafe_view``, ``empty``) move nothing.
          A gather (``index``, ``index_select``, ``gather``, ``embedding``)
          reads at most twice its result's bytes of its operands, as hlo_cost
          windows a gather or a dynamic slice: a row gather from a 2.7 GB
          table reads the rows, not the table. An op that writes in place
          counts its destination as an operand and as a result, as a scatter
          does in hlo_cost.
  ops     the number of aten ops counted.

A Python loop dispatches every iteration, so the count needs no trip-count
correction: a 36-layer loop is 36 layers of ops (``tests/test_torch_dryrun.py``
twins hlo_cost's loop tests on the port's loops).

Each hand-written kernel's entry point (``kernels/ops.py``: ``topk_merge``,
``sweep_merge``, ``sweep_merge_levels``, ``frontier_relax``,
``frontier_relax_rows``, ``minplus_matmul``, ``retrieval_topk``,
``flash_attention``) counts as one op, as a Pallas call is one HLO
instruction: every tensor it reads once, every tensor it writes once, and the
matmul FLOPs its plain version dispatches at those shapes (K6 4*B*H*S*T*D,
the causal mask ignored as XLA counts it; K4 2*M*K*N; K1, K2, K3 and K5
none). Its body runs with the count paused. So a step counts the same
whether a kernel or its plain version runs, on the card, on the CPU and on
``meta``; on ``meta`` an entry gives empty outputs of its stated shapes.

What it does not see: collectives (one card has none; ``collective_s`` is
0), the memory an op needs beside its operands, caching, and fusion: each
torch op is its own kernel, where XLA fuses elementwise chains and counts
bytes only at the fusion's boundary, so the port's bytes are the unfused
traffic of the same function.

The roofline divides by the H100 SXM's data-sheet rates: 989e12 bf16/fp16
dense operations a second on the tensor cores, 67e12 float32 on the CUDA
cores (the port keeps its float32 matmuls at full precision, not TF32), and
3.35e12 bytes a second of HBM.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops

# H100 SXM data-sheet rates
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
OPS_PER_S = {"bfloat16": BF16_OPS_PER_S, "float16": BF16_OPS_PER_S,
             "float32": F32_OPS_PER_S, "float64": 34e12}

# ops that move no bytes: views by their schema, and these
_FREE = {"_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "alias", "_local_scalar_dense"}
# gathers: their operands' bytes are charged at most twice the result's
_GATHERS = {"index", "index_select", "gather", "embedding"}
# not ops at all: a constant made by ``torch.tensor`` is lifted into the
# program (dispatched on the CPU and the card, not on ``meta``), as an HLO
# constant is free
_NOT_OPS = {"lift_fresh"}


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclasses.dataclass
class Count:
    """What one ``count()`` saw: matmul FLOPs by dtype name, bytes, ops, and
    for each kernel entry its calls, FLOPs and bytes."""

    flops_by_dtype: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    bytes: int = 0
    ops: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)
    paused_depth: int = dataclasses.field(default=0, repr=False)

    @property
    def flops(self) -> int:
        return sum(self.flops_by_dtype.values())

    def roofline_terms_s(self) -> dict[str, float]:
        """Seconds at the card's data-sheet rates: the sum over dtypes of
        flops / rate, bytes / HBM rate, and no collective on one card."""
        return {
            "compute_s": sum(n / OPS_PER_S.get(dt, F32_OPS_PER_S)
                             for dt, n in self.flops_by_dtype.items()),
            "memory_s": self.bytes / HBM_BYTES_PER_S,
            "collective_s": 0.0,
        }

    def add(self, flops: int, dtype: torch.dtype | None, moved: int) -> None:
        if flops:
            self.flops_by_dtype[dtype_name(dtype)] += int(flops)
        self.bytes += int(moved)
        self.ops += 1

    def kernel(self, name: str, inputs: list, out, flops: int, dtype, written: list) -> None:
        """One call of a kernel entry (run with the count paused): one op of
        the bytes it reads and writes and ``flops`` of ``dtype``."""
        moved = nbytes(inputs) + nbytes(written) + nbytes(
            [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)])
        self.add(flops, dtype, moved)
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += moved

    @contextlib.contextmanager
    def paused(self):
        self.paused_depth += 1
        try:
            yield
        finally:
            self.paused_depth -= 1

    def as_dict(self) -> dict:
        return {"flops": self.flops, "flops_by_dtype": dict(self.flops_by_dtype),
                "bytes": self.bytes, "ops": self.ops,
                "kernels": {name: dict(k) for name, k in self.kernels.items()}}


class _Watch(TorchDispatchMode):
    def __init__(self, total: Count):
        super().__init__()
        self.total = total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.total.paused_depth:
            return out
        packet = func._overloadpacket
        if packet.__name__ in _NOT_OPS:
            return out
        if func.is_view or packet.__name__ in _FREE:
            moved = 0
        else:
            tensors = lambda tree: [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
            read, written = nbytes(tensors((args, kwargs))), nbytes(tensors(out))
            if packet.__name__ in _GATHERS:
                read = min(read, 2 * written)
            moved = read + written
        flops, dtype = 0, None
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            dtype = next(t for t in tree_leaves(out) if isinstance(t, torch.Tensor)).dtype
        self.total.add(flops, dtype, moved)
        return out


@contextlib.contextmanager
def count():
    """Count the work of every torch op run inside: ``with count() as c:``,
    then ``c.flops``, ``c.bytes``, ``c.roofline_terms_s()``. Counts nest: an
    outer count sees what an inner one sees."""
    total = Count()
    ops.COUNTS.append(total)
    try:
        with _Watch(total):
            yield total
    finally:
        ops.COUNTS.remove(total)
