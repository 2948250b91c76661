"""Shows that chip_smoke.py's equality checks of K5 catch a broken kernel.

For the kernel as it is and for each planted fault, copies ``src/``,
``chip_smoke.py`` and this script into a work directory, edits the copy's
CUDA source there (the checkout's own sources are never touched), and runs
chip_smoke's ``check_retrieval_topk`` in a process of its own, which builds
the copy's kernels. The faults:

- ``merge_strict``: the last block of a row keeps the parts' keys > theta_lb,
  not >=, so where one part holds the row's k best its k-th key, which is
  theta_lb and in the answer, is dropped.
- ``counter_not_reset``: the merging block leaves its row's arrival counter
  at P, so on the next call no block of that row finds itself last and the
  outputs are never written.

Needs one CUDA card and ``nvcc``. Prints the card's name and power limit, then
one JSON line per variant: whether the check passed, and its message if not.
Exits 1 unless the intact kernel passes and each fault fails.

    python3 tools/k5_planted_faults.py [--workdir DIR]
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
SCRIPT = os.path.join("tools", "k5_planted_faults.py")
SOURCE = "retrieval_topk.cu"

# variant -> [(text in the source, its replacement)]; each text must occur exactly once
FAULTS = {
    "intact": [],
    "merge_strict": [(
        "    s.theta = st.lb ? st.lb - 1 : 0;  // keep the keys >= theta_lb\n",
        "    s.theta = st.lb;  // planted fault: keeps the keys > theta_lb\n",
    )],
    "counter_not_reset": [(
        "  if (parts > 1 && tid == 0) arrivals[row] = 0;\n",
        "  // planted fault: the row's arrival counter is left at parts\n",
    )],
}


def plant(copy: str, edits: list[tuple[str, str]]) -> None:
    path = os.path.join(copy, CSRC, SOURCE)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"k5_planted_faults: {old!r} occurs {text.count(old)} times "
                             f"in {SOURCE}, not once")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)


def measure() -> dict:
    """In a copy: chip_smoke's K5 check."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs

    results: dict = {}
    try:
        cs.check_retrieval_topk(torch.device("cuda", 0), results)
        torch.cuda.synchronize()
        return {"passed": True, "timings": {key: results["retrieval_topk"][key]
                                            for key in ("ms", "enqueue_ms", "at_B512")}}
    except AssertionError as err:
        return {"passed": False, "message": str(err)}


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
        print("k5_planted_faults: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    work = args.workdir or tempfile.mkdtemp(prefix="k5_faults_")
    bad = []
    try:
        for name, edits in FAULTS.items():
            copy = os.path.join(work, name)
            shutil.rmtree(copy, ignore_errors=True)
            shutil.copytree(os.path.join(ROOT, "src"), os.path.join(copy, "src"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            for rel in ("chip_smoke.py", SCRIPT):
                os.makedirs(os.path.dirname(os.path.join(copy, rel)), exist_ok=True)
                shutil.copy(os.path.join(ROOT, rel), os.path.join(copy, rel))
            plant(copy, edits)
            run = subprocess.run([sys.executable, os.path.join(copy, SCRIPT), "--measure"],
                                 capture_output=True, text=True, timeout=900)
            if run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr)
                print(json.dumps({"variant": name, "returncode": run.returncode}), flush=True)
                bad.append(name)
                continue
            reading = json.loads(run.stdout.strip().splitlines()[-1])
            print(json.dumps({"variant": name, **reading}), flush=True)
            if reading["passed"] != (name == "intact"):
                bad.append(name)
    finally:
        if not args.workdir:
            shutil.rmtree(work, ignore_errors=True)
    if bad:
        print(f"k5_planted_faults: not as expected: {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
