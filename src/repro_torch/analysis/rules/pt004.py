"""PT004: the id=int32 / dist=float32 contract at the kernel boundary (the
port's REP004).

Every table a kernel reads or writes is an (ids, dists) pair of int32 and
float32 (the paper's n*k*8-byte bound, and the exact-equality checks, both
depend on it). A 64-bit tensor handed to a C entry that reads ``int*`` or
``float*`` is read as garbage, with no error. Flags, at every call of a C
entry point in ``kernels/*.py`` (found as in PT002), a ``.data_ptr()`` of a
tensor the function made 64-bit (``dtype=torch.int64`` / ``float64`` /
``long`` / ``double``, ``.long()``, ``.double()``, ``.to(torch.int64)``)
passed where ``csrc/<lib>.cu`` declares a 32-bit (or narrower) pointer. The
kernels' own 64-bit buffers (K2's bucket-address table and scratch keys,
K4's pair counter, K5's scratch) go to ``long long*`` / ``unsigned long
long*`` / ``void*`` parameters and stay legal, as does ``.long()`` for torch
indexing in the plain versions, which never reaches a C call.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from repro_torch.analysis.callgraph import dotted_name
from repro_torch.analysis.rules import Context, Finding, Rule
from repro_torch.analysis.rules.pt002 import c_declarations, c_kind, call_sites

_WIDE = {"int64", "float64", "long", "double", "uint64", "complex128"}
_WIDE_METHODS = {"long", "double"}


def _wide_dtype(node: ast.AST) -> bool:
    return dotted_name(node).split(".")[-1] in _WIDE


def _is_wide(node: ast.AST, wide_names: set[str]) -> bool:
    """Is this expression a 64-bit tensor, as far as the function shows it?"""
    if isinstance(node, ast.Name):
        return node.id in wide_names
    if isinstance(node, ast.Subscript):
        return _is_wide(node.value, wide_names)
    if isinstance(node, ast.Call):
        if any(kw.arg == "dtype" and _wide_dtype(kw.value) for kw in node.keywords):
            return True
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _WIDE_METHODS:
                return True
            if attr == "to" and node.args and _wide_dtype(node.args[0]):
                return True
            if attr in ("contiguous", "clone", "reshape", "view", "flatten"):
                return _is_wide(node.func.value, wide_names)
    return False


def _wide_names(fn_node: ast.AST) -> set[str]:
    names: set[str] = set()
    for _ in range(3):
        for node in ast.walk(fn_node):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and _is_wide(node.value, names)):
                names.add(node.targets[0].id)
    return names


def _c_wide_ok(param: str) -> bool:
    """May a 64-bit buffer go to this C pointer parameter?"""
    return bool(re.search(r"\b(long\s+long|int64_t|uint64_t|double|size_t|void)\b", param))


def check(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    for path, mod in sorted(ctx.modules.items()):
        if "kernels/" not in path.replace("\\", "/"):
            continue
        csrc = Path(path).parent / "csrc"
        decls: dict[str, dict[str, list[str]]] = {}
        for fn in mod.functions.values():
            wide = _wide_names(fn.node)
            for call, lib, entry, args in call_sites(fn.node):
                if lib not in decls:
                    cu = csrc / f"{lib}.cu"
                    decls[lib] = c_declarations(cu) if cu.exists() else {}
                params = decls[lib].get(entry)
                if params is None:
                    continue  # PT002 reports it
                for i, (a, p) in enumerate(zip(args, params)):
                    if not (isinstance(a, ast.Call) and isinstance(a.func, ast.Attribute)
                            and a.func.attr == "data_ptr"):
                        continue
                    if (c_kind(p) == "pointer" and not _c_wide_ok(p)
                            and _is_wide(a.func.value, wide)):
                        findings.append(Finding(
                            path, a.lineno, a.col_offset, "PT004",
                            f"a 64-bit tensor goes to argument {i} of `{entry}`, which "
                            f"csrc/{lib}.cu declares `{p}`: the id=int32/dist=float32 "
                            "contract at the kernel boundary"))
    return findings


RULE = Rule(
    code="PT004",
    summary="64-bit tensor handed to a 32-bit pointer of a C entry (int32/float32 contract)",
    check=check,
)
