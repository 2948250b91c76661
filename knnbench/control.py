"""The control: the plain reference put in the program's place, computed in a
lower precision, judged as a run's outputs are. The comparison is sound only
if the control fails it.

    python3 -m knnbench.control --workload k100-serve --seeds 11,12,13 [--bits 8] [--exact]

For each seed it draws the cell's traffic as a run does, computes the
tables by the Bellman fixed point, holds them at ``--bits`` significant bits
(default: the configuration's ``control_bits``; ``bellman.lowered``), puts
them in the program's place as the cell's loop says (``Loop.control``: the
served table and its answers, or the checked builds), and prints the numbers the judge reads with their limits. With
``--exact`` it also computes the fixed point in float32 and compares it with
the program's tables (the same seed's): they must be equal. A benchmark run
never runs this; it needs a CUDA device, as a run does.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--bits", type=int, default=None)
    parser.add_argument("--exact", action="store_true")
    args = parser.parse_args(argv)

    from knnbench import harness

    cell = harness.load_cell(args.workload)
    os.environ["REPRO_COMPILE_CACHE"] = str(harness.CACHE / "build")
    sys.path.insert(0, str(harness.SRC))
    import torch

    dev = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        print("knnbench.control: no CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_readings(cell, seed, dev, args.bits, args.exact)), flush=True)
    return 0


def control_readings(cell, seed: int, dev, bits: int | None = None, exact: bool = False,
                     cache_dir=None) -> dict:
    """The judge's numbers for the control of one seed (and, with ``exact``,
    whether the float32 fixed point equals the program's tables)."""
    import torch

    from knnbench import generator, harness
    from knnbench.reference.bellman import Bellman
    from knnbench.reference.dijkstra import Dijkstra

    bits = int(cell.cfg["control_bits"]) if bits is None else bits
    net = harness.make_network(cell.cfg)
    loop = harness.load_loop(cell.mix["loop"])(cell, None, net.n, seed, dev)
    bell = Bellman(net.indptr, net.indices, net.weights, dev)
    dij = Dijkstra(net.indptr, net.indices, net.weights)
    out: dict = {"workload": cell.name, "seed": seed, "bits": bits}
    t0 = time.perf_counter()
    numbers, fixed = loop.control(bell, dij, generator.stream(seed, "picks"), bits)
    out.update(numbers)
    out["control_s"] = time.perf_counter() - t0
    out["limits"] = {name: 0 for name in out if name.startswith("wrong_")}
    if exact:
        from repro_torch.core import construct

        bn, _ = harness.bncache.bngraph(harness.bncache.Loader(harness.bncache.cache_path(
            cache_dir or harness.CACHE, harness.SRC, harness.network_params(cell.cfg))), net,
            lambda obj: None)
        for objects, want_ids, want_d in fixed:
            got = construct.build_knn_tables(bn, objects, loop.k, device=dev)
            out["exact_equal"] = bool(torch.equal(want_ids, got[0]) and torch.equal(want_d, got[1]))
    return out


if __name__ == "__main__":
    sys.exit(main())
