"""Rule registry for the port's static rail.

A rule is a module-level object with a ``code`` ("PT001"), a one-line
``summary``, and a ``check(ctx) -> list[Finding]``. Rules are pure functions
of the parsed tree + call graph; they never import torch, so the whole
static rail runs on a bare-stdlib interpreter.

Shared helpers keep the rules honest about *scope* (``iter_scope`` walks a
function's own body without descending into nested defs; ``iter_module_scope``
walks exactly the expressions that execute at import time) and about
*tensors* (``TensorNames``: which names and expressions of a function are
torch tensors, as far as the function itself shows it).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field

from repro_torch.analysis.callgraph import CallGraph, ModuleInfo, dotted_name


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    code: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"


@dataclass
class Context:
    """Everything a rule may look at."""

    modules: dict[str, ModuleInfo]  # path -> parsed module
    graph: CallGraph

    def torch_aliases(self, mod: ModuleInfo) -> set[str]:
        return {a for a, m in mod.import_aliases.items() if m == "torch"}

    def kernel_aliases(self, mod: ModuleInfo) -> set[str]:
        """Aliases of the port's kernel modules (their entries return tensors)."""
        return {a for a, m in mod.import_aliases.items()
                if m.endswith(("kernels.ops", "kernels.ref"))}


_NESTED = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)


def iter_scope(fn_node: ast.AST):
    """All nodes in a function's own scope, not entering nested defs."""
    todo = list(getattr(fn_node, "body", []))
    while todo:
        node = todo.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, _NESTED):
                todo.append(child)


def iter_module_scope(tree: ast.Module):
    """Nodes whose expressions execute at import time: module statements,
    class bodies, and the decorators and default values of function defs."""
    todo: list[ast.AST] = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            todo.extend(node.decorator_list)
            todo.extend(d for d in node.args.defaults if d is not None)
            todo.extend(d for d in node.args.kw_defaults if d is not None)
            continue
        if isinstance(node, ast.ClassDef):
            todo.extend(node.decorator_list)
            todo.extend(node.body)
            continue
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, _NESTED):
                todo.append(child)


# torch calls that return no tensor (metadata, devices, streams)
TORCH_METADATA = {
    "finfo", "iinfo", "device", "dtype", "Size", "is_tensor", "get_default_dtype",
    "result_type", "promote_types", "can_cast", "is_floating_point",
}
# tensor attributes and methods that give host metadata, not a tensor
_HOST_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout", "names"}
_HOST_METHODS = {"size", "numel", "dim", "data_ptr", "is_contiguous", "element_size",
                 "stride", "storage_offset", "numpy", "tolist", "item", "get_device"}


class TensorNames:
    """Which expressions of one function are torch tensors, as far as the
    function shows it: results of ``torch.*`` calls (metadata and
    ``torch.cuda`` excepted), of the port's kernel entries (``ops.*``,
    ``ref.*``) and of ``self._upload``; parameters annotated ``torch.Tensor``;
    local names bound to any of these; and what indexing, arithmetic or a
    tensor method makes of them. A tensor that arrives through an attribute
    or an unannotated parameter is not seen."""

    def __init__(self, ctx: Context, mod: ModuleInfo, fn_node: ast.AST):
        self.torch = ctx.torch_aliases(mod)
        self.numpy = {a for a, m in mod.import_aliases.items() if m == "numpy"}
        self.kernels = ctx.kernel_aliases(mod)
        self.names: set[str] = set()
        args = getattr(fn_node, "args", None)
        if args is not None:
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                ann = dotted_name(a.annotation) if a.annotation is not None else ""
                if ann.split(".")[-1] == "Tensor":
                    self.names.add(a.arg)
        assigns = [n for n in iter_scope(fn_node) if isinstance(n, (ast.Assign, ast.AnnAssign))]
        for _ in range(3):  # a short fixpoint: x = f(); y = x[0]; z = y + 1
            for node in assigns:
                value = node.value
                if value is None:
                    continue
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name) and self.is_tensor(value):
                        self.names.add(t.id)
                    elif isinstance(t, ast.Tuple) and self._returns_tensors(value):
                        self.names.update(e.id for e in t.elts if isinstance(e, ast.Name))

    def _returns_tensors(self, value: ast.AST) -> bool:
        if isinstance(value, ast.Call):
            return self.is_tensor(value)
        if isinstance(value, ast.Tuple):
            return all(self.is_tensor(e) for e in value.elts)
        return False

    def is_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            parts = name.split(".")
            if parts[0] in self.torch and len(parts) > 1:
                return parts[1] != "cuda" and parts[-1] not in TORCH_METADATA
            if parts[0] in self.kernels and len(parts) > 1:
                return True
            if name == "self._upload":
                return True
            if isinstance(node.func, ast.Attribute):
                return node.func.attr not in _HOST_METHODS and self.is_tensor(node.func.value)
            return False
        if isinstance(node, ast.Attribute):
            return node.attr not in _HOST_ATTRS and self.is_tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.Compare):
            return any(self.is_tensor(x) for x in [node.left, *node.comparators])
        return False


@dataclass
class Rule:
    code: str
    summary: str
    check: "callable" = field(repr=False)


def all_rules() -> list[Rule]:
    from repro_torch.analysis.rules import pt001, pt002, pt004, pt005

    return [pt001.RULE, pt002.RULE, pt004.RULE, pt005.RULE]
