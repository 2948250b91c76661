"""Shows that chip_smoke.py's equality checks of K2 and K4 catch a broken kernel.

For the kernels as they are and for each planted fault, copies ``src/``,
``chip_smoke.py`` and this script into a work directory, edits the copy's
CUDA source there (the checkout's own sources are never touched), and runs
chip_smoke's ``check_minplus`` and ``check_sweep_merge`` (which includes the
one-launch sweep, ``check_sweep_levels``) in a process of its own, which
builds the copy's kernels. The faults:

- ``minplus_pinf_only``: K4 skips a (tile, t slice) pair when either slice is
  all +inf, without asking whether the other holds a NaN or a -inf (whose
  sum with +inf is NaN). The block-sparse cases of ``check_minplus`` put
  such pairs in the input.
- ``sweep_no_barrier``: the one-launch sweep of K2 runs without its grid
  barrier, so a level may read rows that an earlier level has not written
  yet. The synthetic 200-level sweep of ``check_sweep_levels`` depends on
  its order.

Needs one CUDA card and ``nvcc``. Prints the card's name and power limit, then
one JSON line per variant: whether each check passed, and its message if not.
Exits 1 unless the intact kernels pass both checks and each fault fails the
check of its kernel.

    python3 tools/k2_k4_planted_faults.py [--workdir DIR]
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

# variant -> (source file, [(text in it, its replacement)], the check that must fail);
# each text must occur exactly once
FAULTS = {
    "intact": (None, [], None),
    "minplus_pinf_only": ("minplus.cu", [(
        "const bool inert = ((x & kAllPinf) && !(y & kPoison)) || "
        "((y & kAllPinf) && !(x & kPoison));",
        "const bool inert = (x & kAllPinf) || (y & kAllPinf);  // planted fault",
    )], "minplus"),
    "sweep_no_barrier": ("sweep_merge.cu", [(
        "    if (lv + 1 < n_levels) grid_barrier(bar, gridDim.x);",
        "    // planted fault: no grid barrier between levels",
    )], "sweep_merge"),
}
CHECKS = ("minplus", "sweep_merge")


def plant(copy: str, source: str | None, edits: list[tuple[str, str]]) -> None:
    if source is None:
        return
    path = os.path.join(copy, CSRC, source)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"k2_k4_planted_faults: {old!r} occurs {text.count(old)} times "
                             f"in {source}, not once")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)


def measure() -> dict:
    """In a copy: chip_smoke's K4 and K2 checks, each caught on its own."""
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
        print("k2_k4_planted_faults: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    work = args.workdir or tempfile.mkdtemp(prefix="k2_k4_faults_")
    bad = []
    try:
        for name, (source, edits, must_fail) in FAULTS.items():
            copy = os.path.join(work, name)
            shutil.rmtree(copy, ignore_errors=True)
            shutil.copytree(os.path.join(ROOT, "src"), os.path.join(copy, "src"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            for rel in ("chip_smoke.py", os.path.join("tools", "k2_k4_planted_faults.py")):
                os.makedirs(os.path.dirname(os.path.join(copy, rel)), exist_ok=True)
                shutil.copy(os.path.join(ROOT, rel), os.path.join(copy, rel))
            plant(copy, source, edits)
            script = os.path.join(copy, "tools", "k2_k4_planted_faults.py")
            run = subprocess.run([sys.executable, script, "--measure"], capture_output=True,
                                 text=True, timeout=900)
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
        print(f"k2_k4_planted_faults: not as expected: {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
