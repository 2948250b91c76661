"""Times K5 with the parts a row forced, at the shapes ops.retrieval_plan sees.

    python3 tools/k5_variants.py

For each shape and each P, launches the kernel through its C entry point
(one ctypes call, no wrapper), checks the answer against the plain version
(exact), and times it with CUDA events two ways: one launch between two
events (what ``chip_smoke.py`` calls ``ms``, host work around the launch
included) and 50 launches back to back between two events, divided by 50 (the
card's time a launch). Marks the P that ``ops.retrieval_plan`` picks.

With ``--timing`` it builds a second copy of the kernel with ``-DK5_TIMING``
(into a temporary directory) and prints, for one launch at each (shape, P),
the phase times the kernel marks with the card's global timer: the first part
of row 0 (streamed, its k best placed, counted in on the row's counter) and
the block that writes row 0's answer (its start, when it found itself last,
the merge, the answer placed), and each block's count of selections.

Needs one CUDA card and ``nvcc``. Prints the card's name and power limit, then
one JSON line per (shape, P). Exits 1 if an answer differs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timing_build(tmp: str):
    """The kernel built with -DK5_TIMING, and its mark reader."""
    from repro_torch.kernels import _build

    lib = os.path.join(tmp, "libretrieval_timing.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DK5_TIMING", "-o", lib,
                    str(_build.CSRC / "retrieval_topk.cu")], check=True)
    so = ctypes.CDLL(lib)
    fn = so.knn_retrieval_topk
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    marks = so.knn_retrieval_marks
    marks.argtypes, marks.restype = [ctypes.c_void_p], ctypes.c_int
    return fn, marks


def read_marks(marks, parts: int) -> dict:
    """The marks of the last launch, in microseconds (with one part a row, the
    first part is the answer block and has no part phases)."""
    buf = (ctypes.c_ulonglong * 16)()
    if marks(ctypes.addressof(buf)):
        raise RuntimeError("knn_retrieval_marks failed")
    first, last = list(buf[:8]), list(buf[8:])
    us = lambda a, b: (b - a) / 1e3  # noqa: E731
    out = {"answer_block_selects": last[4],
           "answer_block_us": {"start_after_first_part_start": us(first[0], last[0]),
                               "arrived_last": us(last[0], last[1]),
                               "merged": us(last[1], last[2]),
                               "placed_written": us(last[2], last[3]),
                               "first_part_start_to_end": us(first[0], last[3])}}
    if parts > 1:
        out["first_part_us"] = {"streamed": us(first[0], first[1]),
                                "placed": us(first[1], first[4]),
                                "counted_in": us(first[4], first[2])}
        out["first_part_selects"] = first[3]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timing", action="store_true",
                    help="also print the kernel's phase times (a -DK5_TIMING build)")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from repro_torch.kernels import _build, ops, ref

    if not torch.cuda.is_available():
        print("k5_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    fn = ops._fn("retrieval_topk", "knn_retrieval_topk")
    tmp = tempfile.mkdtemp(prefix="k5_timing_")
    timed_fn, marks = timing_build(tmp) if args.timing else (None, None)
    n = 1_000_000
    shapes = {
        "random (1, 10^6, 100)": (torch.randn((1, n), generator=gen, device=dev), 100,
                                  (1, 32, 64, 128, 163, 244, 488, 528)),
        "ascending (1, 10^6, 100)": (torch.arange(n, dtype=torch.float32, device=dev)[None], 100,
                                     (1, 64, 163, 244, 488)),
        "random (1, 10^6, 1024)": (torch.randn((1, n), generator=gen, device=dev), 1024,
                                   (1, 4, 8, 16)),
        "random (512, 10^6, 100)": (torch.randn((512, n), generator=gen, device=dev), 100,
                                    (1, 2, 3)),
    }
    bad = False
    for name, (s, k, variants) in shapes.items():
        b = s.shape[0]
        plan = ops.retrieval_plan(b, n, k, ops.retrieval_slots(dev, s.dtype, k))
        want = ref.retrieval_topk_ref(s, k)
        for parts in sorted(set(variants) | {plan}):
            ids = torch.empty((b, k), dtype=torch.int32, device=dev)
            out = torch.empty((b, k), dtype=torch.float32, device=dev)
            stream = ops._stream(dev)
            arrivals, scratch = ops._retrieval_buffers(dev, stream, b, parts, k)
            args = (s.data_ptr(), 0, b, n, k, parts, scratch.data_ptr(), arrivals.data_ptr(),
                    ids.data_ptr(), out.data_ptr(), stream)

            def launch():
                code = fn(*args)
                if code:
                    raise RuntimeError(f"launch failed: {code}")

            launch()
            torch.cuda.synchronize()
            equal = torch.equal(ids, want[0]) and torch.equal(out, want[1])
            bad |= not equal
            one, many = [], []
            for _ in range(10):
                a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                launch()
                z.record()
                torch.cuda.synchronize()
                one.append(a.elapsed_time(z))
                a.record()
                for _ in range(50):
                    launch()
                z.record()
                torch.cuda.synchronize()
                many.append(a.elapsed_time(z) / 50)
            line = {"shape": name, "parts": parts, "plan": parts == plan, "equal": equal,
                    "ms_one_call": statistics.median(one),
                    "ms_per_launch": statistics.median(many)}
            if timed_fn is not None:
                for _ in range(3):  # the last of three launches
                    if timed_fn(*args):
                        raise RuntimeError("timing build: launch failed")
                    torch.cuda.synchronize()
                line["phases"] = read_marks(marks, parts)
            print(json.dumps(line), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
