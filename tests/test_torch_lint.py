"""Tests for the port's static analysis (src/repro_torch/lint, replint-torch).

Covers: parity with the JAX package's linter on its own corpus (the CPL and
REP rules give the same rule ids on the same lines), the port's corpus
(every rule fires on its fixture and stays silent on the clean twin), the
call graph's reachability against the JAX graph module by module, the
port's own tree linting clean, the staticness classifier's PyTorch
judgments, and the engine surface (suppression forms, the marker syntax,
JSON, CLI exit codes), as tests/test_lint.py covers the JAX linter."""
import ast
import json
import textwrap
from pathlib import Path

import pytest

from repro.lint import lint_paths as jax_lint_paths
from repro.lint.engine import build_context as jax_build_context
from repro.lint.engine import parse_comments as jax_parse_comments
from repro_torch.lint import lint_paths
from repro_torch.lint.__main__ import DEFAULT_PATHS, main
from repro_torch.lint.callgraph import build_graph, build_imports
from repro_torch.lint.engine import build_context, parse_comments
from repro_torch.lint.rules import ALL_RULES, get_rule
from repro_torch.lint.rules.kernels import launch_sites
from repro_torch.lint.selftest import SELFTEST_IDS, check_rule

REPO = Path(__file__).resolve().parent.parent
JAX_CORPUS = REPO / "tests" / "lint_fixtures"


def _lint_src(tmp_path, source, name="mod.py", **kw):
    f = tmp_path / name
    f.write_text(textwrap.dedent(source))
    kw.setdefault("respect_scope", False)
    return lint_paths([str(f)], root=tmp_path, **kw)


def _rules_of(report):
    return [f.rule for f in report.findings]


def _ids_lines(report):
    return sorted((f.rule, f.line) for f in report.findings)


# ---------------------------------------------------------------------------------
# parity with the JAX linter on its corpus, and the port's own corpus
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("name", [f"{r}_{k}.py" for r in ("cpl301", "cpl302", "cpl303",
                                                           "rep001", "rep002")
                                  for k in ("fire", "clean")])
def test_parity_with_jax_linter_on_its_corpus(name, tmp_path):
    """Same rule ids on the same lines as ``repro.lint``; the REP cases with
    their comments translated to the port's ``# replint-torch:`` syntax."""
    src = JAX_CORPUS / name
    jax = jax_lint_paths([str(src)], root=REPO, respect_scope=False, include_fixtures=True)
    text = src.read_text()
    if name.startswith("rep"):
        assert "# replint: " in text
        text = text.replace("# replint: ", "# replint-torch: ")
    (tmp_path / name).write_text(text)
    port = lint_paths([str(tmp_path / name)], root=tmp_path, respect_scope=False)
    assert _ids_lines(port) == _ids_lines(jax)
    assert bool(port.findings) == name.endswith("_fire.py")


@pytest.mark.parametrize("rule_id", SELFTEST_IDS)
def test_rule_corpus(rule_id):
    """Every port rule fires on tests/lint_fixtures/torch/<id>_fire.py and is
    silent on the _clean twin."""
    assert check_rule(rule_id, REPO) == []


def test_every_rule_has_an_id_and_description():
    ids = [r.id for r in ALL_RULES]
    assert len(ids) == len(set(ids))
    assert {i[:3] for i in ids} == {"TRC", "KRN", "CPL"}
    for r in ALL_RULES:
        assert r.description and r.name
    assert get_rule("TRC101") is get_rule("host-sync")
    assert get_rule("KRN204") is get_rule("silent-fallback")


def test_control_plane_rules_keep_the_jax_scope():
    """CPL301/302 cover the port's core/{chaos,convergence,scaling}, nothing
    more (serving/fleet.py reads the wall clock on purpose); CPL303 runs on
    every file, as in JAX."""
    for rid in ("CPL301", "CPL302"):
        rule = get_rule(rid)
        for d in ("chaos", "convergence", "scaling"):
            assert rule.applies(f"src/repro_torch/core/{d}/x.py")
        assert not rule.applies("src/repro_torch/serving/fleet.py")
        assert not rule.applies("src/repro/core/scaling/x.py")
    assert get_rule("CPL303").applies("anything.py")


# ---------------------------------------------------------------------------------
# reachability: the port's graph against the JAX package's, module by module
# ---------------------------------------------------------------------------------

#: names JAX's graph reaches that the port defines but does not reach, and why
REACH_EXEMPT = {
    "src/repro_torch/models/lm.py": {
        "init_block_params": "JAX vmaps the block init, which puts it under trace; the "
                             "port initialises eagerly, off the hot path"},
    "src/repro_torch/models/mamba_lm.py": {
        "init_mamba_layer": "JAX vmaps the layer init; the port initialises eagerly"},
    "src/repro_torch/models/whisper.py": {
        "_init_dec_block": "JAX vmaps the block init; the port initialises eagerly"},
}


def _jax_modules():
    out = []
    for base in ("serving", "models", "kernels"):
        for f in sorted((REPO / "src" / "repro" / base).rglob("*.py")):
            if f.name in ("kernel.py", "ref.py"):
                continue
            if base == "kernels" and f.name != "ops.py":
                continue
            out.append(f.relative_to(REPO).as_posix())
    return out


@pytest.mark.parametrize("jax_path", _jax_modules())
def test_reachability_covers_the_jax_graph(jax_path):
    """Every function JAX's graph marks jit-reachable that the port also
    defines is reachable in the port's graph (or listed in REACH_EXEMPT)."""
    port_path = jax_path.replace("src/repro/", "src/repro_torch/")
    jax = jax_build_context(REPO / jax_path, jax_path)
    port = build_context(REPO / port_path, port_path)
    wanted = {f.qualname for f in jax.graph.jit_reachable_functions()}
    defined = {f.qualname for f in port.graph.functions.values()}
    reached = {f.qualname for f in port.graph.jit_reachable_functions()}
    exempt = REACH_EXEMPT.get(port_path, {})
    assert set(exempt) <= wanted & defined - reached, "stale exemption"
    assert (wanted & defined) - reached - set(exempt) == set()


def test_traced_markers_sit_where_jax_roots_are():
    """The port marks the counterparts of the JAX package's explicit
    ``# replint: traced`` roots, and nothing carries the JAX syntax."""
    for f in sorted((REPO / "src" / "repro").rglob("*.py")):
        rel = f.relative_to(REPO / "src" / "repro")
        if rel.parts[0] not in ("serving", "models", "kernels"):
            continue
        _, jax_traced = jax_parse_comments(f.read_text())
        if not jax_traced:
            continue
        port = REPO / "src" / "repro_torch" / rel
        _, traced = parse_comments(port.read_text())
        assert len(traced) >= len(jax_traced) - (rel.name == "kvcache.py"), rel
    for f in (REPO / "src" / "repro_torch").rglob("*.py"):
        suppressions, traced = jax_parse_comments(f.read_text())
        assert not suppressions and not traced, f


def _reachable(source):
    src = textwrap.dedent(source)
    tree = ast.parse(src)
    _, traced = parse_comments(src)
    g = build_graph(tree, build_imports(tree), traced)
    return {f.qualname for f in g.jit_reachable_functions()}, g


def test_reachability_roots():
    names, g = _reachable("""
        import functools
        import torch

        def helper(x):
            return x + 1

        @torch.compile
        def hot(x):
            return helper(x)

        def body(step, x):
            return x * step

        def graphed(x):
            return x

        def captured(x):
            return x

        class Engine:
            def _step(self, x):
                return self._inner(x)

            def _inner(self, x):
                return x

            def __init__(self):
                self.fn = torch.compile(functools.partial(self._step))
                self.g = torch.cuda.make_graphed_callables((graphed, body), ((1,), (1,)))

        def capture(x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = captured(x)
            return y

        # replint-torch: traced -- entered from another module
        def entry(x):
            return helper(x)

        def cold(x):
            return x
        """)
    assert names == {"hot", "helper", "body", "graphed", "captured", "Engine._step",
                     "Engine._inner", "entry"}
    assert len(g.capture_regions) == 1


# ---------------------------------------------------------------------------------
# the port's tree
# ---------------------------------------------------------------------------------

def test_real_tree_is_clean():
    """The acceptance gate: the default paths lint clean, every suppression
    carrying its reason."""
    report = lint_paths(DEFAULT_PATHS, root=REPO)
    assert report.findings == [], "\n".join(
        f"{f.location()} {f.rule}: {f.message}" for f in report.findings)
    assert report.suppressed, "the intended loop-exit syncs are suppressed findings"
    for f in report.suppressed:
        assert f.reason, f"reasonless suppression at {f.location()}"
    engine = [f for f in report.suppressed if f.path == "src/repro_torch/serving/engine.py"]
    assert [f.rule for f in engine] == ["TRC101", "TRC101"]
    assert all("ROADMAP item 2" in f.reason for f in engine)


def test_every_kernel_wrapper_is_a_launch_site():
    """The KRN rules anchor on ``.data_ptr()`` launches: each ``ops.py``
    wrapper module has them, so the rules see every kernel."""
    for ops in sorted((REPO / "src" / "repro_torch" / "kernels").glob("*/ops.py")):
        tree = ast.parse(ops.read_text())
        assert list(launch_sites(tree)), ops


def test_fixture_corpus_is_excluded_by_default():
    report = lint_paths(["tests"], root=REPO)
    assert report.n_files > 0
    assert not any("lint_fixtures" in f.path for f in report.findings + report.suppressed)


# ---------------------------------------------------------------------------------
# staticness judgments (PyTorch semantics)
# ---------------------------------------------------------------------------------

def test_metadata_and_config_are_host_values(tmp_path):
    report = _lint_src(tmp_path, """
        import torch

        @torch.compile
        def hot(x, params, cfg: ModelConfig, n_layers: int = 4, extra=None):
            n = int(x.shape[0]) + int(x.numel()) + x.size(1) + x.dim()
            if cfg.moe and x.is_cuda and x.device.type == "cuda":
                x = x + n
            for bp in params["blocks"]:        # a pytree: a list of dicts
                x = x @ bp["w"]
            for k, v in params.items():
                x = x + 0
            if extra is None:
                return x
            return x + extra
        """)
    assert report.findings == []


def test_host_syncs_fire(tmp_path):
    report = _lint_src(tmp_path, """
        import torch

        # replint-torch: traced -- test
        def hot(x, ev):
            a = x.to("cpu")
            b = x.sum().to(device="cpu")
            ev.synchronize()
            y = torch.softmax(x, -1)
            return a, b, float(y.max()), y.numpy()
        """)
    assert _rules_of(report) == ["TRC101"] * 5


def test_tensor_branch_through_assignment(tmp_path):
    report = _lint_src(tmp_path, """
        import torch

        @torch.compile
        def hot(x):
            y = torch.relu(x)
            if y.any():
                return y
            return -y
        """)
    assert _rules_of(report) == ["TRC102"]


def test_capture_region_bodies_are_checked(tmp_path):
    """A ``with torch.cuda.graph(...)`` body is checked with its owner's
    names, in a function and at module level; what follows it is not."""
    report = _lint_src(tmp_path, """
        import torch

        x = torch.zeros(3)
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            if x.any():
                x = x + 1
        print(x)

        def run(y):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                z = float(y.sum())
            return float(y.max()), z
        """)
    assert [(f.rule, f.line) for f in report.findings] == [("TRC102", 6), ("TRC101", 12)]


def test_unknown_values_stay_silent(tmp_path):
    report = _lint_src(tmp_path, """
        import torch

        @torch.compile
        def hot(x, split):
            start = split.span(x.shape[1])      # not a tensor method
            if start > 0:
                x = x[:, start:]
            return x
        """)
    assert report.findings == []


# ---------------------------------------------------------------------------------
# engine surface: suppressions, the marker syntax, JSON, CLI
# ---------------------------------------------------------------------------------

def test_suppression_forms(tmp_path):
    reasoned = _lint_src(tmp_path, """
        def f(plan):
            plan._x = 1  # replint-torch: disable=CPL303 -- test: exercising the API
            # replint-torch: disable=private-mutation -- test: next line, by name
            plan._y = 1
            plan._z = 1  # replint-torch: disable=ALL -- test: blanket
        """)
    assert reasoned.findings == []
    assert [f.rule for f in reasoned.suppressed] == ["CPL303"] * 3
    assert reasoned.suppressed[0].reason == "test: exercising the API"
    leak = _lint_src(tmp_path, """
        def f(plan):
            plan._x = 1  # replint-torch: disable=CPL303 -- test: this line only
            plan._y = 2
        """, name="leak.py")
    assert _rules_of(leak) == ["CPL303"] and leak.findings[0].line == 4
    bare = _lint_src(tmp_path, """
        def f(plan):
            plan._x = 1  # replint-torch: disable=CPL303
        """, name="bare.py")
    assert _rules_of(bare) == ["REP001"]
    unused = _lint_src(tmp_path, """
        def f():
            return 1  # replint-torch: disable=TRC101 -- nothing syncs here
        """, name="unused.py")
    assert _rules_of(unused) == ["REP002"]


def test_the_two_marker_syntaxes_do_not_cross():
    """The JAX linter reads only ``# replint:``, the port's only
    ``# replint-torch:``; a suppression in one syntax is invisible to the
    other tool."""
    torch_src = "x = 1  # replint-torch: disable=TRC101 -- r\n# replint-torch: traced -- t\n"
    jax_src = "x = 1  # replint: disable=TRC101 -- r\n# replint: traced -- t\n"
    assert jax_parse_comments(torch_src) == ([], frozenset())
    assert parse_comments(jax_src) == ([], frozenset())
    supp, traced = parse_comments(torch_src)
    assert [s.rules for s in supp] == [("TRC101",)] and traced == {2}


def test_select_limits_rules_and_skips_meta(tmp_path):
    report = _lint_src(tmp_path, """
        import time

        def decide():
            return time.time()

        def other():
            return 1  # replint-torch: disable=TRC102 -- unrelated, must not REP002
        """, select=("CPL301",))
    assert _rules_of(report) == ["CPL301"]


def test_json_report_roundtrip(tmp_path):
    report = _lint_src(tmp_path, """
        def f(plan):
            plan._x = 1
        """)
    out = tmp_path / "report.json"
    report.write_json(out)
    data = json.loads(out.read_text())
    assert data["tool"] == "replint-torch"
    assert data["n_findings"] == 1 and data["counts"] == {"CPL303": 1}
    assert data["findings"][0]["rule"] == "CPL303"
    assert set(data) == set(jax_lint_paths([]).to_json())
    assert report.exit_code == 1


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(plan):\n    plan._x = 1\n")
    good = tmp_path / "good.py"
    good.write_text("def f():\n    return 1\n")
    assert main([str(bad), "--root", str(tmp_path), "--no-scope"]) == 1
    assert main([str(good), "--root", str(tmp_path), "--no-scope"]) == 0
    out = capsys.readouterr().out
    assert "CPL303" in out and "replint-torch:" in out
    with pytest.raises(SystemExit) as exc:
        main(["--no-such-flag"])
    assert exc.value.code == 2
    assert main(["--list-rules"]) == 0
    assert main(["--selftest", "--root", str(REPO), "-q"]) == 0


def test_syntax_error_file_is_rep000(tmp_path):
    f = tmp_path / "broken.py"
    f.write_text("def broken(:\n")
    report = lint_paths([str(f)], root=tmp_path, respect_scope=False)
    assert _rules_of(report) == ["REP000"]
    assert build_context(f, "broken.py") is None
