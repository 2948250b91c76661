"""AST call graph over the port with its guarded regions as the roots.

The static rail's foundation: PT001 ("no host sync on a guarded path") is a
property of *reachability*: ``.cpu()`` is fine in a constructor and a silent
round trip three frames below ``query_batch``'s guard. This module builds,
with nothing but the stdlib ``ast``:

* a table of every function/method in the analyzed tree, keyed
  ``path:qualname`` (nested defs use dotted qualnames, ``outer.inner``);
* the *guarded regions*: the bodies of ``with sanitize.guard(...)`` /
  ``with no_transfers(...)`` blocks, directly or through a local name bound
  to an expression that makes such a call (the flush's
  ``flush_guard = sanitize.guard("flush") if ... else nullcontext()``).
  The calls made inside a region are the *roots*, the counterpart of the JAX
  rail's jit / shard_map / pallas_call boundaries;
* a conservative call graph: name calls resolve within the module, imported
  names resolve across analyzed modules (``from repro_torch.kernels import
  ops`` then ``ops.topk_merge(...)``), and ``self.method()`` resolves to every
  analyzed method of that name (over-approximate on purpose: a lint rule
  must not lose an edge to polymorphism), and so does a bound method taken
  as a value (``provider = self._insert_frontier``), which is called later;
* the transitive *reachable* set from the roots, minus the two sanctioned
  crossings (``SANCTIONED``: the engines' ``_upload`` and ``_readback``),
  which are neither checked nor walked through.

Resolution is intentionally name-based and over-approximate: a false edge
costs a spurious review, a missing edge a silent host sync on a hot path.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field

# call tails that open a guarded region when used as a ``with`` item
GUARD_CALLS = {"guard", "no_transfers"}
# the explicit crossings: the only functions a guarded path may sync in
SANCTIONED = {"_upload", "_readback"}


def dotted_name(node: ast.AST) -> str:
    """Full dotted source text of a Name/Attribute chain, '' otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _makes_guard(node: ast.AST) -> bool:
    """Does this expression call ``guard(...)`` / ``no_transfers(...)``?"""
    return any(
        isinstance(sub, ast.Call) and dotted_name(sub.func).split(".")[-1] in GUARD_CALLS
        for sub in ast.walk(node)
    )


@dataclass
class FunctionInfo:
    key: str                     # "relpath:qualname"
    path: str                    # file the function lives in (relative)
    module: str                  # dotted module guess ("repro_torch.kernels.ops")
    qualname: str
    node: ast.AST                # FunctionDef | AsyncFunctionDef
    calls: set[str] = field(default_factory=set)         # resolved keys
    method_calls: set[str] = field(default_factory=set)  # bare self.X names
    # the same two, for the calls made inside this function's guarded regions
    root_calls: set[str] = field(default_factory=set)
    root_method_calls: set[str] = field(default_factory=set)
    regions: list[ast.With] = field(default_factory=list)  # guarded with-blocks


@dataclass
class ModuleInfo:
    path: str
    module: str
    tree: ast.Module
    source: str
    # import alias -> dotted module ("ops" -> "repro_torch.kernels.ops")
    import_aliases: dict[str, str] = field(default_factory=dict)
    # imported name -> "module.attr"
    from_imports: dict[str, str] = field(default_factory=dict)
    functions: dict[str, FunctionInfo] = field(default_factory=dict)  # qualname ->


def module_name_for(path: str) -> str:
    """Best-effort dotted module for a file path (anchored at ``repro_torch``)."""
    parts = [p for p in path.replace("\\", "/")[:-3].split("/") if p not in ("", ".")]
    if "repro_torch" in parts:
        parts = parts[parts.index("repro_torch"):]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class _DefCollector(ast.NodeVisitor):
    """Pass 1: register every function/method, so a call to a function
    defined later in the file still resolves."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.stack: list[str] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        qual = ".".join(self.stack + [node.name])
        self.mod.functions[qual] = FunctionInfo(
            key=f"{self.mod.path}:{qual}", path=self.mod.path, module=self.mod.module,
            qualname=qual, node=node,
        )
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()


class _ModuleScanner(ast.NodeVisitor):
    """Pass 2 per module: imports, guarded regions, call edges."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.stack: list[str] = []
        self.fn_stack: list[FunctionInfo] = []
        self.guard_names: list[set[str]] = []  # per function: names bound to a guard
        self.depth = 0  # nesting of guarded regions around the current node

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.mod.import_aliases[alias.asname or alias.name.split(".")[0]] = alias.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        base = node.module or ""
        for alias in node.names:
            local = alias.asname or alias.name
            self.mod.from_imports[local] = f"{base}.{alias.name}" if base else alias.name
            # "from repro_torch.kernels import ops" imports a MODULE: record
            # the alias too so "ops.topk_merge" resolves across modules
            self.mod.import_aliases.setdefault(local, f"{base}.{alias.name}")

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.stack.append(node.name)
        info = self.mod.functions[".".join(self.stack)]
        names = {
            t.id
            for sub in ast.walk(node)
            if isinstance(sub, ast.Assign) and _makes_guard(sub.value)
            for t in sub.targets if isinstance(t, ast.Name)
        }
        self.fn_stack.append(info)
        self.guard_names.append(names)
        depth, self.depth = self.depth, 0  # a nested def is not inside the region
        self.generic_visit(node)
        self.depth = depth
        self.guard_names.pop()
        self.fn_stack.pop()
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def _is_guard_item(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Call) and _makes_guard(expr):
            return True
        return isinstance(expr, ast.Name) and bool(self.guard_names) and (
            expr.id in self.guard_names[-1])

    def visit_With(self, node: ast.With) -> None:
        guarded = bool(self.fn_stack) and any(
            self._is_guard_item(item.context_expr) for item in node.items)
        for item in node.items:
            self.visit(item)
        if guarded:
            self.fn_stack[-1].regions.append(node)
            self.depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if guarded:
            self.depth -= 1

    visit_AsyncWith = visit_With

    def _resolve_local(self, name: str) -> str | None:
        """A bare name, resolved against enclosing scopes then the module."""
        for depth in range(len(self.stack), -1, -1):
            qual = ".".join(self.stack[:depth] + [name])
            if qual in self.mod.functions:
                return qual
        return None

    def _edges(self) -> tuple[set[str], set[str]]:
        info = self.fn_stack[-1]
        if self.depth:
            return info.root_calls, info.root_method_calls
        return info.calls, info.method_calls

    def visit_Attribute(self, node: ast.Attribute) -> None:
        # self.method taken as a value: an edge, as if called
        if (self.fn_stack and isinstance(node.value, ast.Name)
                and node.value.id in ("self", "cls") and isinstance(node.ctx, ast.Load)):
            self._edges()[1].add(node.attr)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if self.fn_stack:
            calls, methods = self._edges()
            name = dotted_name(node.func)
            head, _, rest = name.partition(".")
            if head in ("self", "cls") and rest and "." not in rest:
                methods.add(rest)
            elif name and "." not in name:
                local = self._resolve_local(name)
                if local is not None:
                    calls.add(f"{self.mod.path}:{local}")
                elif name in self.mod.from_imports:
                    calls.add(f"import:{self.mod.from_imports[name]}")
            elif head in self.mod.import_aliases and rest:
                calls.add(f"import:{self.mod.import_aliases[head]}.{rest}")
        self.generic_visit(node)


@dataclass
class CallGraph:
    modules: dict[str, ModuleInfo]            # path -> module
    functions: dict[str, FunctionInfo]        # key -> info
    reachable: set[str]                       # keys reachable from the roots

    def roots(self) -> list[FunctionInfo]:
        """Functions holding a guarded region."""
        return [f for f in self.functions.values() if f.regions]


def build_callgraph(modules: dict[str, ModuleInfo]) -> CallGraph:
    """Scan every module, then close the roots over the call graph."""
    for mod in modules.values():
        _DefCollector(mod).visit(mod.tree)
        _ModuleScanner(mod).visit(mod.tree)

    functions: dict[str, FunctionInfo] = {}
    by_module_attr: dict[str, str] = {}
    by_method_name: dict[str, list[str]] = {}
    for mod in modules.values():
        for fn in mod.functions.values():
            functions[fn.key] = fn
            if mod.module:
                by_module_attr[f"{mod.module}.{fn.qualname}"] = fn.key
            if "." in fn.qualname:  # a method or nested def: callable by name
                by_method_name.setdefault(fn.qualname.split(".")[-1], []).append(fn.key)

    def resolve(edge: str) -> list[str]:
        if edge.startswith("import:"):
            target = edge[len("import:"):]
            if "repro_torch" in target:
                target = target[target.index("repro_torch"):]
            key = by_module_attr.get(target)
            return [key] if key else []
        return [edge] if edge in functions else []

    def targets(calls, methods) -> list[str]:
        out = [t for edge in calls for t in resolve(edge)]
        out += [t for m in methods for t in by_method_name.get(m, [])]
        return [t for t in out if functions[t].qualname.split(".")[-1] not in SANCTIONED]

    frontier = []
    for fn in functions.values():
        frontier.extend(targets(fn.root_calls, fn.root_method_calls))
    reachable = set(frontier)
    while frontier:
        nxt: list[str] = []
        for key in frontier:
            fn = functions[key]
            found = targets(fn.calls | fn.root_calls, fn.method_calls | fn.root_method_calls)
            # a nested def inside a reachable function runs on its path too
            prefix = f"{fn.path}:{fn.qualname}."
            found += [k for k in functions if k.startswith(prefix)]
            for t in found:
                if t not in reachable:
                    reachable.add(t)
                    nxt.append(t)
        frontier = nxt
    return CallGraph(modules=modules, functions=functions, reachable=reachable)
