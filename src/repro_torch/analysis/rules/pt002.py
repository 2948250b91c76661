"""PT002: the ctypes boundary (the port's REP002).

The Pallas kernels' hazard was an off-by-N alias index; the port's is the
same bug class at its ctypes boundary: a wrapper in ``kernels/*.py`` calls a
C entry point of ``csrc/<lib>.cu`` through ``_fn("<lib>", "<entry>")``, and
nothing but discipline keeps the three descriptions of that entry in step:

* the ``extern "C"`` declaration in ``csrc/<lib>.cu``;
* its ctypes signature in the module's ``_SIGNATURES`` table (a pointer
  declared ``c_int`` is cut to 32 bits, a stream passed as an int as well);
* every call site's arguments.

Checked: the table's argument count and kinds (pointer / integer / float)
against the declaration, and each call site's argument count and pointer
kinds against it. A call argument is a pointer when it is a ``.data_ptr()``,
a stream (``_stream(...)`` / ``.cuda_stream``) or ``None``; ``*f(...)`` of a
module function that returns a fixed-length tuple counts as that many
integers. An entry with no declaration is itself a finding.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from repro_torch.analysis.callgraph import dotted_name
from repro_torch.analysis.rules import Context, Finding, Rule

_DECL = re.compile(r'extern\s+"C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)', re.S)
_CTYPES = {
    "c_void_p": "pointer", "c_char_p": "pointer",
    "c_int": "int", "c_uint": "int", "c_long": "int", "c_longlong": "int",
    "c_size_t": "int", "c_int32": "int", "c_int64": "int",
    "c_float": "float", "c_double": "float",
}


def c_kind(param: str) -> str:
    """'pointer', 'float' or 'int' of one C parameter declaration."""
    if "*" in param or "cudaStream_t" in param:
        return "pointer"
    if re.search(r"\b(float|double)\b", param):
        return "float"
    return "int"


def c_declarations(cu: Path) -> dict[str, list[str]]:
    """``extern "C"`` entry -> the parameter declarations, in order."""
    text = re.sub(r"//[^\n]*", "", cu.read_text())
    out = {}
    for name, params in _DECL.findall(text):
        params = " ".join(params.split())
        out[name] = [] if params in ("", "void") else [p.strip() for p in params.split(",")]
    return out


def _module_assigns(tree: ast.Module) -> dict[str, ast.AST]:
    out: dict[str, ast.AST] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name):
                out[t.id] = node.value
            elif isinstance(t, ast.Tuple) and isinstance(node.value, ast.Tuple):
                for e, v in zip(t.elts, node.value.elts):
                    if isinstance(e, ast.Name):
                        out[e.id] = v
    return out


def _kinds(node: ast.AST, names: dict[str, ast.AST], depth: int = 0) -> list[str] | None:
    """Evaluate a ctypes argtypes list expression to kinds; None if opaque."""
    if depth > 8:
        return None
    if isinstance(node, (ast.List, ast.Tuple)):
        out: list[str] = []
        for e in node.elts:
            k = _kinds(e, names, depth + 1)
            if k is None:
                return None
            out += k
        return out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left, right = _kinds(node.left, names, depth + 1), _kinds(node.right, names, depth + 1)
        return None if left is None or right is None else left + right
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        if isinstance(node.right, ast.Constant) and isinstance(node.right.value, int):
            inner = _kinds(node.left, names, depth + 1)
            return None if inner is None else inner * node.right.value
        return None
    if isinstance(node, ast.Name) and node.id in names:
        return _kinds(names[node.id], names, depth + 1)
    kind = _CTYPES.get(dotted_name(node).split(".")[-1])
    return None if kind is None else [kind]


def _fn_target(call: ast.AST) -> tuple[str, str] | None:
    """("lib", "entry") of a ``_fn("lib", "entry")`` call."""
    if (isinstance(call, ast.Call) and dotted_name(call.func).split(".")[-1] == "_fn"
            and len(call.args) == 2
            and all(isinstance(a, ast.Constant) and isinstance(a.value, str)
                    for a in call.args)):
        return call.args[0].value, call.args[1].value
    return None


def _tuple_returns(fn: ast.AST) -> int | None:
    """Length of the tuple every ``return`` of ``fn`` gives, if one length."""
    lengths = {len(r.value.elts) for r in ast.walk(fn)
               if isinstance(r, ast.Return) and isinstance(r.value, ast.Tuple)}
    plain = [r for r in ast.walk(fn) if isinstance(r, ast.Return)
             and not isinstance(r.value, ast.Tuple)]
    return lengths.pop() if len(lengths) == 1 and not plain else None


def _arg_kind(node: ast.AST, pointers: set[str] = frozenset()) -> str:
    """'pointer' or 'value' of one call argument; ``pointers`` are local
    names bound to a pointer."""
    if isinstance(node, ast.Constant) and node.value is None:
        return "pointer"
    if isinstance(node, ast.Name) and node.id in pointers:
        return "pointer"
    if isinstance(node, ast.IfExp):
        kinds = {_arg_kind(node.body, pointers), _arg_kind(node.orelse, pointers)}
        return "pointer" if "pointer" in kinds else "value"
    if isinstance(node, ast.Call):
        func = node.func
        tail = func.attr if isinstance(func, ast.Attribute) else dotted_name(func)
        if tail in ("data_ptr", "_stream"):
            return "pointer"
    if isinstance(node, ast.Attribute) and node.attr == "cuda_stream":
        return "pointer"
    return "value"


def pointer_names(fn_node: ast.AST) -> set[str]:
    """Local names bound to a pointer (``stream = _stream(dev)``)."""
    return {
        node.targets[0].id
        for node in ast.walk(fn_node)
        if isinstance(node, ast.Assign) and len(node.targets) == 1
        and isinstance(node.targets[0], ast.Name) and _arg_kind(node.value) == "pointer"
    }


def call_sites(fn_node: ast.AST):
    """(call, lib, entry, argument expressions) for every C call in a
    function: ``_fn(l, e)(...)`` directly, or through a local name bound to
    ``_fn(l, e)``; ``*args`` of a local tuple is expanded."""
    bound: dict[str, tuple[str, str]] = {}
    tuples: dict[str, list[ast.AST]] = {}
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name):
                target = _fn_target(node.value)
                if target:
                    bound[t.id] = target
                elif isinstance(node.value, ast.Tuple):
                    tuples[t.id] = list(node.value.elts)
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call):
            continue
        target = _fn_target(node.func)
        if target is None and isinstance(node.func, ast.Name):
            target = bound.get(node.func.id)
        if target is None:
            continue
        args: list[ast.AST] = []
        for a in node.args:
            if isinstance(a, ast.Starred) and isinstance(a.value, ast.Name) and (
                    a.value.id in tuples):
                args += tuples[a.value.id]
            else:
                args.append(a)
        yield node, target[0], target[1], args


def _expand_starred(args, mod) -> list[ast.AST] | None:
    out: list[ast.AST] = []
    for a in args:
        if not isinstance(a, ast.Starred):
            out.append(a)
            continue
        if isinstance(a.value, ast.Call):
            fn = mod.functions.get(dotted_name(a.value.func))
            n = _tuple_returns(fn.node) if fn is not None else None
            if n is not None:
                out += [ast.Constant(0)] * n
                continue
        return None
    return out


def check(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    for path, mod in sorted(ctx.modules.items()):
        if "kernels/" not in path.replace("\\", "/"):
            continue
        csrc = Path(path).parent / "csrc"
        decls: dict[str, dict[str, list[str]]] = {}

        def decl(lib: str, entry: str):
            if lib not in decls:
                cu = csrc / f"{lib}.cu"
                decls[lib] = c_declarations(cu) if cu.exists() else {}
            return decls[lib].get(entry)

        names = _module_assigns(mod.tree)
        sigs = names.get("_SIGNATURES")
        sig_kinds: dict[str, list[str] | None] = {}
        if isinstance(sigs, ast.Dict):
            for k, v in zip(sigs.keys, sigs.values):
                if isinstance(k, ast.Constant) and isinstance(v, ast.Tuple) and v.elts:
                    sig_kinds[k.value] = _kinds(v.elts[0], names)
        seen_sig: set[str] = set()
        for fn in mod.functions.values():
            pointers = pointer_names(fn.node)
            for call, lib, entry, args in call_sites(fn.node):
                params = decl(lib, entry)
                if params is None:
                    findings.append(Finding(
                        path, call.lineno, call.col_offset, "PT002",
                        f"`{entry}` has no extern \"C\" declaration in csrc/{lib}.cu"))
                    continue
                want = [c_kind(p) for p in params]
                if entry in sig_kinds and entry not in seen_sig:
                    seen_sig.add(entry)
                    got = sig_kinds[entry]
                    if got != want:
                        findings.append(Finding(
                            path, sigs.lineno, sigs.col_offset, "PT002",
                            f"_SIGNATURES[{entry!r}] declares {got}, csrc/{lib}.cu "
                            f"declares {want}"))
                expanded = _expand_starred(args, mod)
                if expanded is None:
                    findings.append(Finding(
                        path, call.lineno, call.col_offset, "PT002",
                        f"cannot count the arguments of the call to `{entry}`"))
                    continue
                if len(expanded) != len(params):
                    findings.append(Finding(
                        path, call.lineno, call.col_offset, "PT002",
                        f"`{entry}` called with {len(expanded)} arguments, csrc/{lib}.cu "
                        f"declares {len(params)}"))
                    continue
                for i, (a, p, k) in enumerate(zip(expanded, params, want)):
                    got = _arg_kind(a, pointers)
                    if (k == "pointer") != (got == "pointer"):
                        findings.append(Finding(
                            path, getattr(a, "lineno", call.lineno),
                            getattr(a, "col_offset", call.col_offset), "PT002",
                            f"argument {i} of `{entry}` is a {got}, csrc/{lib}.cu "
                            f"declares `{p}`"))
    return findings


RULE = Rule(
    code="PT002",
    summary="ctypes call / _SIGNATURES vs the extern \"C\" declaration in csrc/",
    check=check,
)
