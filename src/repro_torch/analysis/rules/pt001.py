"""PT001: a host sync on a guarded path (the port's REP001).

Flags, inside a guarded region (``with sanitize.guard(...)``) and in every
function reachable from one, outside the two sanctioned crossings
(``_upload`` / ``_readback``):

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and ``.nonzero()``
  calls, and ``torch.nonzero``: each reads a device value back, so the host
  waits for the device;
* ``int()`` / ``float()`` / ``bool()`` of a tensor (``rules.TensorNames``
  decides what is one; ``.shape`` and the other metadata are host values);
* an upload: ``torch.tensor`` / ``torch.as_tensor``, ``.cuda()``, and
  ``.to(x)`` unless ``x`` is a dtype (``torch.float32``, ``y.dtype``, a name
  holding ``dtype``): a blocking host -> device copy.

Under ``REPRO_SANITIZE=1`` each of these raises on the card; this rule finds
them before a run does, on paths a test never takes. A deliberate crossing
belongs in one of the two helpers, where it is counted; a numpy ``.tolist()``
the rule cannot tell from a tensor's carries a reasoned pragma.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.callgraph import dotted_name
from repro_torch.analysis.rules import Context, Finding, Rule, TensorNames, iter_scope

_READBACKS = {"item", "tolist", "cpu", "numpy", "nonzero"}
_CASTS = {"int", "float", "bool"}
_UPLOADS = {"tensor", "as_tensor"}


def _is_dtype(node: ast.AST, torch_aliases: set[str]) -> bool:
    name = dotted_name(node)
    if not name:
        return False
    parts = name.split(".")
    if parts[-1] == "dtype" or "dtype" in parts[-1].lower():
        return True
    return parts[0] in torch_aliases and len(parts) == 2


def _sync(node: ast.Call, tensors: TensorNames) -> str | None:
    """What host sync this call makes, or None."""
    name = dotted_name(node.func)
    parts = name.split(".")
    if parts[0] in tensors.numpy:
        return None  # host arrays: np.nonzero, np.asarray, ... never sync
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if parts[0] in tensors.torch and len(parts) == 2:
            if attr == "nonzero":
                return "`torch.nonzero` reads the count back"
            if attr in _UPLOADS:
                return f"`torch.{attr}` builds a host tensor to upload"
            return None
        if attr in _READBACKS:
            return f"`.{attr}()` reads a device value back"
        if attr == "cuda":
            return "`.cuda()` is a blocking upload"
        if attr == "to":
            dev = [kw.value for kw in node.keywords if kw.arg == "device"]
            first = node.args[0] if node.args else None
            if dev or (first is not None and not _is_dtype(first, tensors.torch)):
                return "`.to(device)` is a blocking upload"
        return None
    if isinstance(node.func, ast.Name) and node.func.id in _CASTS and node.args:
        if tensors.is_tensor(node.args[0]):
            return f"`{node.func.id}()` of a tensor reads it back"
    return None


def _check_nodes(ctx: Context, fn, nodes, where: str) -> list[Finding]:
    mod = ctx.modules[fn.path]
    tensors = TensorNames(ctx, mod, fn.node)
    out = []
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        what = _sync(node, tensors)
        if what:
            out.append(Finding(
                fn.path, node.lineno, node.col_offset, "PT001",
                f"{what} {where} `{fn.qualname}`; cross through "
                "EngineCore._upload / _readback, which count it",
            ))
    return out


def check(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    for key in sorted(ctx.graph.reachable):
        fn = ctx.graph.functions[key]
        findings += _check_nodes(ctx, fn, iter_scope(fn.node),
                                 "inside guard-reachable")
    for fn in ctx.graph.roots():
        if fn.key in ctx.graph.reachable:
            continue  # its whole body was checked above
        nodes = [sub for region in fn.regions for stmt in region.body for sub in ast.walk(stmt)]
        findings += _check_nodes(ctx, fn, nodes, "inside the guarded region of")
    return findings


RULE = Rule(
    code="PT001",
    summary="host sync (.item/.cpu/.numpy/.tolist/int()/upload) on a guarded path",
    check=check,
)
