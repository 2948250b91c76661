"""Run one cell of the benchmark and print its result as the last line.

    python3 -m knnbench.run --workload k20-serve --seed 7 --seconds 10 --trace 0

from the root of a checkout. With ``--trace 0`` the result holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace over a steady part of the window and from the
benchmark's own spans. It measures the port (``src/repro_torch``) on CUDA
devices only: without them it exits 3 and prints no result.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(message: str, code: int) -> None:
    print(f"knnbench: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        fail("--seed must be a non-negative whole number", 2)

    from knnbench import bncache, spec

    cell = spec.load_cell(args.workload)
    if not spec.SRC.joinpath("repro_torch").is_dir():
        fail(f"the program is not here: {spec.SRC / 'repro_torch'} is missing", 4)
    # the cached BN-Graph is read while torch loads
    loader = bncache.Loader(bncache.cache_path(spec.CACHE, spec.SRC,
                                               spec.network_params(cell.cfg)))
    # every cache of the program stays in the checkout, at a fixed path
    cache = spec.CACHE
    os.environ["REPRO_COMPILE_CACHE"] = str(cache / "build")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(spec.SRC))

    import torch

    from knnbench import harness

    if not torch.cuda.is_available():
        fail("no CUDA device: this benchmark measures the port on the card only", 3)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} CUDA devices, "
             f"{torch.cuda.device_count()} present", 3)

    result, checks = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                      torch.device("cuda", 0), T_PROCESS, log=log, loader=loader)
    found = harness.forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {found}", 5)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, (value, limit) in checks.items()}
    for name, (value, limit) in checks.items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    ordered = {key: result[key] for key in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in result:
        ordered["breakdown"] = result["breakdown"]
    ordered["checks"] = result["checks"]
    print(json.dumps(ordered), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
