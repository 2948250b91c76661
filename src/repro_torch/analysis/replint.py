"""The port's static rail. ``python -m repro_torch.analysis.replint src/repro_torch``.

Stdlib-only by construction (no torch, numpy, jax or ``repro`` import
anywhere on this path): it runs on a bare interpreter.

Suppression policy, the JAX rail's under a keyword of its own: a finding is
silenced only by

    # port-lint: disable=PT001(reason why this is safe)

on the offending line, or on the ``def``/``class`` line of the enclosing
block (which silences that rule for the whole block). The reason string is
**mandatory**: a bare ``disable=PT001`` is itself reported (PT000). Exit
status is 1 iff any finding survives. The JAX rail (``repro.analysis``)
scans ``src/`` too, the port included; its pragma keyword and codes
(``replint``, ``REPxxx``) are not these, so neither rail reads the other's
pragmas.
"""
from __future__ import annotations

import argparse
import ast
import json
import re
import sys
from pathlib import Path

from repro_torch.analysis.callgraph import ModuleInfo, build_callgraph, module_name_for
from repro_torch.analysis.rules import Context, Finding, all_rules

_PRAGMA_RE = re.compile(r"#\s*port-lint:\s*disable=(.+)$")
_CODE_WITH_REASON = re.compile(r"(PT\d{3})\s*\(([^)]*)\)")
_CODE_BARE = re.compile(r"(PT\d{3})(?!\s*\()")


def collect_files(paths: list[str]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(f for f in sorted(path.rglob("*.py")) if "__pycache__" not in f.parts)
        elif path.suffix == ".py":
            files.append(path)
    return files


def parse_modules(files: list[Path]) -> tuple[dict[str, ModuleInfo], list[Finding]]:
    modules: dict[str, ModuleInfo] = {}
    errors: list[Finding] = []
    for f in files:
        rel = f.as_posix()
        try:
            source = f.read_text()
            tree = ast.parse(source, filename=rel)
        except (SyntaxError, UnicodeDecodeError) as exc:
            line = getattr(exc, "lineno", 1) or 1
            errors.append(Finding(rel, line, 0, "PT000", f"parse error: {exc}"))
            continue
        modules[rel] = ModuleInfo(path=rel, module=module_name_for(rel), tree=tree,
                                  source=source)
    return modules, errors


class Suppressions:
    """Per-file map of (code -> suppressed line ranges) from pragmas."""

    def __init__(self, mod: ModuleInfo):
        self.ranges: dict[str, list[tuple[int, int]]] = {}
        self.bad_pragmas: list[Finding] = []
        blocks: dict[int, int] = {}  # def/class lineno -> end_lineno
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                blocks[node.lineno] = node.end_lineno or node.lineno
        for lineno, line in enumerate(mod.source.splitlines(), start=1):
            m = _PRAGMA_RE.search(line)
            if not m:
                continue
            spec = m.group(1)
            for code in _CODE_BARE.findall(_CODE_WITH_REASON.sub("", spec)):
                self.bad_pragmas.append(Finding(
                    mod.path, lineno, 0, "PT000",
                    f"pragma disables {code} without a reason: write "
                    f"`# port-lint: disable={code}(why this is safe)`"))
            for code, reason in _CODE_WITH_REASON.findall(spec):
                if not reason.strip():
                    self.bad_pragmas.append(Finding(
                        mod.path, lineno, 0, "PT000",
                        f"pragma disables {code} with an empty reason"))
                    continue
                self.ranges.setdefault(code, []).append((lineno, blocks.get(lineno, lineno)))

    def covers(self, finding: Finding) -> bool:
        return any(lo <= finding.line <= hi for lo, hi in self.ranges.get(finding.code, []))


def run(paths: list[str], select: set[str] | None = None) -> list[Finding]:
    modules, findings = parse_modules(collect_files(paths))
    graph = build_callgraph(modules)
    ctx = Context(modules=modules, graph=graph)
    suppressions = {path: Suppressions(mod) for path, mod in modules.items()}
    for sup in suppressions.values():
        findings.extend(sup.bad_pragmas)
    for rule in all_rules():
        if select and rule.code not in select:
            continue
        for f in rule.check(ctx):
            sup = suppressions.get(f.path)
            if sup is None or not sup.covers(f):
                findings.append(f)
    return sorted(set(findings), key=lambda f: (f.path, f.line, f.col, f.code, f.message))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="replint", description="the port's static rail")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"], help="files or directories")
    ap.add_argument("--select", help="comma-separated rule codes (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.code}  {rule.summary}")
        return 0

    select = set(args.select.split(",")) if args.select else None
    findings = run(args.paths or ["src/repro_torch"], select)
    if args.as_json:
        print(json.dumps([f.__dict__ for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        n = len(findings)
        print(f"replint: {n} finding{'s' if n != 1 else ''}" if n else "replint: clean")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
