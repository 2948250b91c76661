"""The port's static rail (``repro_torch.analysis.replint``): fixture twins,
pragma policy, a clean port, stdlib-only imports.

Case for case ``tests/analysis/test_replint.py``: every registered rule must
own a ``<code>_bad.py`` fixture it fires on and a ``<code>_clean.py`` twin it
stays silent on (``tests/torch_replint_fixtures/``; PT002 and PT004 under
``kernels/``, checked against ``kernels/csrc/fx.cu``). The JAX rail's own
test keeps running over all of ``src/``, the port included: the port's
pragmas (``# port-lint: ...``, codes PTxxx) are invisible to it.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis.replint import main, run
from repro_torch.analysis.rules import all_rules

FIXTURES = Path(__file__).parent / "torch_replint_fixtures"
REPO = Path(__file__).resolve().parents[1]


def _codes(path: Path) -> set[str]:
    return {f.code for f in run([str(path)])}


def test_every_jax_rule_but_rep003_has_a_port_rule():
    assert [r.code for r in all_rules()] == ["PT001", "PT002", "PT004", "PT005"]


@pytest.mark.parametrize("rule", all_rules(), ids=lambda r: r.code)
def test_rule_fires_on_bad_fixture(rule):
    bads = sorted(FIXTURES.rglob(f"{rule.code.lower()}_bad.py"))
    assert bads, f"{rule.code} has no firing fixture; add one under {FIXTURES}"
    for bad in bads:
        assert rule.code in _codes(bad), f"{rule.code} silent on {bad.name}"


@pytest.mark.parametrize("rule", all_rules(), ids=lambda r: r.code)
def test_rule_silent_on_clean_twin(rule):
    cleans = sorted(FIXTURES.rglob(f"{rule.code.lower()}_clean.py"))
    assert cleans, f"{rule.code} has no clean twin fixture"
    for clean in cleans:
        assert rule.code not in _codes(clean), f"{rule.code} fires on {clean.name}"


def test_clean_twins_are_fully_clean():
    for clean in sorted(FIXTURES.rglob("*_clean.py")):
        findings = run([str(clean)])
        assert findings == [], "\n".join(f.render() for f in findings)


def test_bad_fixtures_name_each_planted_fault():
    # one finding per planted line, so a rule that goes quiet on one case shows
    lines = {code: sorted({f.line for f in run([str(p)]) if f.code == code})
             for code, p in (("PT001", FIXTURES / "pt001_bad.py"),
                             ("PT002", FIXTURES / "kernels" / "pt002_bad.py"),
                             ("PT004", FIXTURES / "kernels" / "pt004_bad.py"),
                             ("PT005", FIXTURES / "pt005_bad.py"))}
    assert lines == {"PT001": [18, 20, 21, 26, 27], "PT002": [7, 17, 18, 19],
                     "PT004": [15], "PT005": [4, 5, 6]}


def test_port_src_is_clean():
    findings = run([str(REPO / "src" / "repro_torch")])
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_rail_reaches_the_flush_and_query_paths():
    from repro_torch.analysis.callgraph import build_callgraph
    from repro_torch.analysis.replint import collect_files, parse_modules

    modules, _ = parse_modules(collect_files([str(REPO / "src" / "repro_torch")]))
    graph = build_callgraph(modules)
    roots = {f.qualname for f in graph.roots()}
    assert roots == {"EngineCore.query_batch", "EngineCore.flush_updates", "_moe_ffn"}
    reached = {k.split(":")[1] for k in graph.reachable}
    for name in ("_moe_route", "_moe_dispatch",
                 "QueryEngine._gather_batch", "ShardedQueryEngine._gather_batch",
                 "QueryEngine._insert_frontier", "QueryEngine._repair",
                 "ShardedQueryEngine._insert_frontier", "ShardedQueryEngine._frontier_round",
                 "QueryEngine._frontier_candidates", "ShardedQueryEngine._fhalo",
                 "QueryEngine._repair_part", "ShardedQueryEngine._repair_part_host",
                 "ShardedQueryEngine._prepare_publish", "rows_purge_merge", "topk_merge"):
        assert name in reached, name
    # the two sanctioned crossings are neither checked nor walked through
    assert not {"EngineCore._upload", "EngineCore._readback"} & reached


def test_exit_codes():
    bad = FIXTURES / "pt005_bad.py"
    clean = FIXTURES / "pt005_clean.py"
    assert main([str(bad)]) == 1
    assert main([str(clean)]) == 0
    assert main(["--list-rules"]) == 0


def test_select_filters_rules():
    bad = FIXTURES / "pt001_bad.py"
    assert {f.code for f in run([str(bad)], select={"PT001"})} == {"PT001"}
    assert run([str(bad)], select={"PT005"}) == []


def test_static_rail_is_stdlib_only():
    code = (
        "import sys; import repro_torch.analysis.replint, repro_torch.analysis.rules; "
        "from repro_torch.analysis.rules import all_rules; all_rules(); "
        "bad = [m for m in ('torch', 'numpy', 'jax', 'repro') if m in sys.modules]; "
        "assert not bad, f'static rail imported {bad}'"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env)


def test_jax_rail_reads_no_port_pragma(tmp_path):
    # the JAX rail must neither honour nor reject the port's pragmas
    from repro.analysis.replint import run as jax_run

    f = tmp_path / "mod.py"
    f.write_text("x = 1  # port-lint: disable=PT005\n")
    assert jax_run([str(f)]) == []


# ---------------------------------------------------------------------------
# pragma policy
# ---------------------------------------------------------------------------


def test_reasoned_pragma_suppresses(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(
        "import torch\n"
        "T = torch.arange(8)  # port-lint: disable=PT005(test table, built once)\n"
    )
    assert run([str(f)]) == []


def test_bare_pragma_is_rejected(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(
        "import torch\n"
        "T = torch.arange(8)  # port-lint: disable=PT005\n"
    )
    codes = {x.code for x in run([str(f)])}
    assert "PT000" in codes  # reasonless pragma is itself a finding
    assert "PT005" in codes  # and it does NOT suppress


def test_empty_reason_is_rejected(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(
        "import torch\n"
        "T = torch.arange(8)  # port-lint: disable=PT005( )\n"
    )
    assert "PT000" in {x.code for x in run([str(f)])}


_GUARDED = (
    "from repro_torch.analysis import sanitize\n"
    "class E:\n"
    "    def q(self, x):\n"
    "        with sanitize.guard('query'):\n"
    "            return self.a(x), self.b(x)\n"
)


def test_def_line_pragma_covers_block(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(
        _GUARDED
        + "    def a(self, x):  # port-lint: disable=PT001(a measured baseline, unguarded)\n"
        "        return x.cpu()\n"
        "    def b(self, x):\n"
        "        return x\n"
    )
    assert run([str(f)]) == []


def test_pragma_does_not_leak_past_block(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(
        _GUARDED
        + "    def a(self, x):  # port-lint: disable=PT001(a measured baseline, unguarded)\n"
        "        return x.cpu()\n"
        "    def b(self, x):\n"
        "        return x.cpu()\n"
    )
    assert [(x.code, x.line) for x in run([str(f)])] == [("PT001", 9)]
