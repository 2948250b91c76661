"""PT005: nothing at import touches the card (the port's REP005).

A tensor made at import time (``torch.tensor``, ``torch.zeros``,
``torch.empty``, ...) lands on the default device of whoever imports first;
anything under ``torch.cuda`` or a ``.cuda()`` / ``.to(...)`` at import time
initialises CUDA before the process has picked a device, fails on a machine
without a card (the CPU tests import every module), and runs again in every
process that imports the module. Constants belong in Python or numpy, or
inside the first call that needs them.

Metadata is exempt: ``torch.finfo`` / ``iinfo``, dtype objects
(``torch.int32`` is an attribute, not a call) and ``torch.device(...)``,
which names a device without touching it.

The import-time surface is walked precisely: module body, class bodies,
decorator expressions and default argument values.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.callgraph import dotted_name
from repro_torch.analysis.rules import (
    TORCH_METADATA,
    Context,
    Finding,
    Rule,
    iter_module_scope,
)


def check(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    for path, mod in sorted(ctx.modules.items()):
        torch_roots = ctx.torch_aliases(mod)
        for node in iter_module_scope(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            parts = name.split(".")
            what = None
            if parts[0] in torch_roots and len(parts) > 1:
                if parts[1] == "cuda":
                    what = f"`{name}(...)` initialises CUDA"
                elif parts[-1] not in TORCH_METADATA:
                    what = f"`{name}(...)` makes a tensor"
            elif isinstance(node.func, ast.Attribute) and node.func.attr in ("cuda", "to"):
                what = f"`.{node.func.attr}(...)` moves a tensor"
            if what:
                findings.append(Finding(
                    path, node.lineno, node.col_offset, "PT005",
                    f"module-level {what} at import time (before a device is chosen, "
                    "on every import, and on machines without a card); use Python or "
                    "numpy, or move it inside the first call that needs it"))
    return findings


RULE = Rule(
    code="PT005",
    summary="module-level torch tensor / CUDA work (device work at import time)",
    check=check,
)
