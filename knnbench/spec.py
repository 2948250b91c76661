"""The benchmark's cells, read from ``BENCHMARK.json`` and the files it
names. Imports nothing heavy, so a run can start reading its inputs before
torch is loaded."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
SRC = ROOT / "src"
CACHE = PKG / ".cache"


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files, by name."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    work = cells[name]
    entry = next(c for c in spec["configs"] if c["name"] == work["config"])
    cfg = json.loads((root / entry["file"]).read_text())
    mix = json.loads((PKG / "traffic" / f"{work['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, cfg, mix, int(work["chips"]), e2e, layer)


def network_params(cfg: dict) -> dict:
    """The road network's generator parameters, as the BN-Graph cache keys them."""
    net = dict(cfg["network"])
    net.pop("generator", None)
    return net
