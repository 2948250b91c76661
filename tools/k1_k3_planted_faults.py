"""Shows that chip_smoke.py's equality checks of K1 and K3 catch a broken kernel.

For the kernels as they are and for each planted fault, copies ``src/``,
``chip_smoke.py`` and this script into a work directory, edits the copy's
CUDA source there (the checkout's own sources are never touched), and runs
chip_smoke's ``check_topk_merge`` and ``check_frontier_relax`` in a process of
its own, which builds the copy's kernels. The faults:

- ``relax_in_place``: K3 also writes each new row into the distance matrix
  it reads, as a Gauss-Seidel round would, so a receiver that neighbours
  another may read the other's new row. The checks' receivers neighbour each
  other, and they hold the matrix unchanged.
- ``topk_no_id_tiebreak``: the shared selection (``kround.cuh``) drops its
  second ``redux.sync``, the smallest id among the lanes holding the minimum
  distance, and takes the first such lane's id: ties no longer go to the
  smaller id. The K1 checks' distances are small integers, so ties abound.

Needs one CUDA card and ``nvcc``. Prints the card's name and power limit, then
one JSON line per variant: whether each check passed, and its message if not.
Exits 1 unless the intact kernels pass both checks and each fault fails the
check of its kernel.

    python3 tools/k1_k3_planted_faults.py [--workdir DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("src", "repro_torch", "kernels", "csrc")
SCRIPT = os.path.join("tools", "k1_k3_planted_faults.py")

# variant -> (source file, [(text in it, its replacement)], the check that must fail);
# each text must occur exactly once
FAULTS = {
    "intact": (None, [], None),
    "relax_in_place": ("frontier_relax.cu", [(
        "      store_cols<V>(out + i * b + c, acc);\n",
        "      store_cols<V>(out + i * b + c, acc);\n"
        "      store_cols<V>(const_cast<float*>(dist) + v * b + c, acc);  // planted fault\n",
    )], "frontier_relax"),
    "topk_no_id_tiebreak": ("kround.cuh", [(
        "  const unsigned lo = __reduce_min_sync(\n"
        "      0xffffffffu, static_cast<unsigned>(v >> 32) == hi ? static_cast<unsigned>(v) "
        ": 0xffffffffu);\n",
        "  const unsigned lo = __shfl_sync(  // planted fault: the first lane's id\n"
        "      0xffffffffu, static_cast<unsigned>(v),\n"
        "      __ffs(__ballot_sync(0xffffffffu, static_cast<unsigned>(v >> 32) == hi)) - 1);\n",
    )], "topk_merge"),
}
CHECKS = ("topk_merge", "frontier_relax")


def plant(copy: str, source: str | None, edits: list[tuple[str, str]]) -> None:
    if source is None:
        return
    path = os.path.join(copy, CSRC, source)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"k1_k3_planted_faults: {old!r} occurs {text.count(old)} times "
                             f"in {source}, not once")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)


def measure() -> dict:
    """In a copy: chip_smoke's K1 and K3 checks, each caught on its own."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.configs.knn_index import make_config

    dev = torch.device("cuda", 0)
    cfg = make_config()
    out = {}
    for name in CHECKS:
        results: dict = {}
        try:
            getattr(cs, f"check_{name}")(cfg, dev, results)
            torch.cuda.synchronize()
            out[name] = {"passed": True}
        except AssertionError as err:
            out[name] = {"passed": False, "message": str(err)}
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", help="where the copies go (default: a new temporary directory)")
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure()))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("k1_k3_planted_faults: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    work = args.workdir or tempfile.mkdtemp(prefix="k1_k3_faults_")
    bad = []
    try:
        for name, (source, edits, must_fail) in FAULTS.items():
            copy = os.path.join(work, name)
            shutil.rmtree(copy, ignore_errors=True)
            shutil.copytree(os.path.join(ROOT, "src"), os.path.join(copy, "src"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            for rel in ("chip_smoke.py", SCRIPT):
                os.makedirs(os.path.dirname(os.path.join(copy, rel)), exist_ok=True)
                shutil.copy(os.path.join(ROOT, rel), os.path.join(copy, rel))
            plant(copy, source, edits)
            run = subprocess.run([sys.executable, os.path.join(copy, SCRIPT), "--measure"],
                                 capture_output=True, text=True, timeout=900)
            if run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr)
                print(json.dumps({"variant": name, "returncode": run.returncode}), flush=True)
                bad.append(name)
                continue
            reading = json.loads(run.stdout.strip().splitlines()[-1])
            print(json.dumps({"variant": name, **reading}), flush=True)
            if must_fail is None:
                expected = all(reading[check]["passed"] for check in CHECKS)
            else:
                expected = not reading[must_fail]["passed"]
            if not expected:
                bad.append(name)
    finally:
        if not args.workdir:
            shutil.rmtree(work, ignore_errors=True)
    if bad:
        print(f"k1_k3_planted_faults: not as expected: {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
