"""The port's static analysis (``tpu_distalg_torch/analysis/``) against the
JAX package's (``tpu_distalg/analysis/``), rule case by rule case.

The cases are the JAX package's own: every test of
``tests/test_analysis.py`` that runs the analyzer, and the TDA120 tests
of ``tests/test_tune.py``. Each runs here under a :class:`Twin`, which
stands in for the JAX analyzer's entry points (``lint_source``,
``lint_file``, ``lint_tree``, ``fix_source``). A call runs the JAX
analyzer as the test asked, then the port's on the same source, written
under the port's root at the same relative path with ``tpu_distalg``
read as ``tpu_distalg_torch``, and asserts equal findings: code, path,
line, column, message, snippet and statement end, with the name
swapped (a column moves by the six characters of ``_torch`` for each
swapped name before it on its line). The call then hands the JAX test
the PORT's findings, spelled back, so the test's own expected codes,
lines and messages are asserted on the port's output.

A JAX test that reads the JAX package's committed tree (its lint gate,
its baseline, its bench contract, its protocol document) is not a rule
case: :data:`NOT_RULE_CASES` names each, with where its counterpart
runs. Violating sources live in strings only.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import pathlib
import re

import pytest
import test_analysis as jcases
import test_tune as jtune_cases

from tpu_distalg import analysis as jan
from tpu_distalg.analysis import engine as jengine
from tpu_distalg.analysis import fixes as jfixes
from tpu_distalg.analysis import project as jproject
from tpu_distalg_torch import analysis as pan
from tpu_distalg_torch.analysis import engine as pengine
from tpu_distalg_torch.analysis import fixes as pfixes
from tpu_distalg_torch.analysis import project as pproject
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

JAX_NAME = re.compile(r"\btpu_distalg\b")
PORT_NAME = re.compile(r"\btpu_distalg_torch\b")
#: what a swapped name adds to a column
SHIFT = len("_torch")


def swap(text: str) -> str:
    return JAX_NAME.sub(pengine.PKG, text)


def unswap(text: str) -> str:
    return PORT_NAME.sub("tpu_distalg", text)


def _line(source_lines, line: int) -> str:
    return source_lines[line - 1] if 1 <= line <= len(source_lines) else ""


def _read_lines(path: str) -> list:
    try:
        with open(path, encoding="utf-8") as f:
            return f.read().splitlines()
    except OSError:
        return []


class Twin:
    """Runs the port's analyzer beside each call a JAX test makes of the
    JAX analyzer, asserts equal findings, and returns the port's.

    ``jroot`` is the JAX test's ``tmp_path``; the port's files go under
    ``proot`` at the same relative paths, swapped. A JAX test's working
    directory inside ``jroot`` maps to the same place in ``proot``; one
    outside (the repo, where the JAX CLI tests lint absolute paths)
    stays as it is."""

    def __init__(self, jroot: pathlib.Path, proot: pathlib.Path):
        self.jroot, self.proot = str(jroot), str(proot)
        self.calls = 0
        self.fired: set = set()     # codes some call reported
        self.clean: set = set()     # codes some call ran and did not

    # -- paths ---------------------------------------------------------

    def _map_abs(self, path: str, src: str, dst: str, rename) -> str | None:
        rel = os.path.relpath(path, src)
        if rel == "." or rel.startswith(".."):
            return None
        return os.path.join(dst, rename(rel))

    def port_path(self, path: str) -> str:
        """A path as the JAX side spells it (relative to its cwd, or
        absolute) in the port's spelling (relative to the port's cwd)."""
        if os.path.isabs(path):
            hit = self._map_abs(path, self.jroot, self.proot, swap)
            return hit if hit is not None else swap(path)
        return swap(path)

    def jax_path(self, path: str) -> str:
        if os.path.isabs(path):
            hit = self._map_abs(path, self.proot, self.jroot, unswap)
            return hit if hit is not None else unswap(path)
        return unswap(path)

    def port_cwd(self) -> str:
        cwd = os.getcwd()
        hit = self._map_abs(cwd, self.jroot, self.proot, swap)
        if hit is not None:
            return hit
        return self.proot if cwd == self.jroot else cwd

    # -- findings ------------------------------------------------------

    def expect(self, v, jlines) -> tuple:
        """A JAX finding as the port must spell it."""
        line = _line(jlines, v.line)
        col = v.col + SHIFT * len(JAX_NAME.findall(line[:v.col]))
        return (v.code, self.port_path(v.path), v.line, col,
                swap(v.message), swap(v.snippet), v.end_line)

    @staticmethod
    def key(v) -> tuple:
        return (v.code, v.path, v.line, v.col, v.message, v.snippet,
                v.end_line)

    def back(self, v, plines):
        """A port finding spelled as the JAX test reads findings."""
        line = _line(plines, v.line)
        col = v.col - SHIFT * len(PORT_NAME.findall(line[:v.col]))
        return dataclasses.replace(
            v, path=self.jax_path(v.path), col=col,
            message=unswap(v.message), snippet=unswap(v.snippet))

    def forward(self, v, jlines):
        code, path, line, col, message, snippet, end = self.expect(
            v, jlines)
        return pengine.Violation(code=code, message=message, path=path,
                                 line=line, col=col, snippet=snippet,
                                 end_line=end)

    def _tally(self, codes_run, found) -> None:
        got = {v.code for v in found}
        self.fired |= got
        self.clean |= set(codes_run) - got

    @staticmethod
    def _port_rules(rules, family) -> tuple:
        codes = {r.code for r in rules}
        return tuple(r for r in family if r.code in codes)

    @staticmethod
    def _codes_run(rules, select, ignore) -> set:
        codes = {r.code for r in rules} | {"TDA000"}
        return {c for c in codes if (not select or c in select)
                and (not ignore or c not in ignore)}

    # -- the stand-ins -------------------------------------------------

    def lint_source(self, source, path, rules, *, select=None,
                    ignore=None):
        want = self.originals["lint_source"](source, path, rules,
                                             select=select, ignore=ignore)
        got = pengine.lint_source(swap(source), self.port_path(path),
                                  self._port_rules(rules, pan.RULES),
                                  select=select, ignore=ignore)
        jlines, plines = source.splitlines(), swap(source).splitlines()
        assert [self.key(v) for v in got] == [self.expect(v, jlines)
                                             for v in want]
        self.calls += 1
        self._tally(self._codes_run(rules, select, ignore), got)
        return [self.back(v, plines) for v in got]

    def lint_tree(self, files, rules, project_rules, *, select=None,
                  ignore=None, changed_only=None, cache_dir=None):
        files = list(files)
        want = self.originals["lint_tree"](
            files, rules, project_rules, select=select, ignore=ignore,
            changed_only=changed_only, cache_dir=cache_dir)
        jcwd, pcwd = os.getcwd(), self.port_cwd()
        pfiles = []
        for f in files:
            with open(f, encoding="utf-8") as fh:
                text = fh.read()
            pf = self.port_path(f)
            dst = pf if os.path.isabs(pf) else os.path.join(pcwd, pf)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            with open(dst, "w", encoding="utf-8") as fh:
                fh.write(swap(text))
            pfiles.append(pf)
        pcache = cache_dir if cache_dir is None \
            or not os.path.isabs(cache_dir) else self.port_path(cache_dir)
        pchanged = None if changed_only is None else {
            self.port_path(p) for p in changed_only}
        os.chdir(pcwd)
        try:
            got = pproject.lint_tree(
                pfiles, self._port_rules(rules, pan.RULES),
                self._port_rules(project_rules, pan.PROJECT_RULES),
                select=select, ignore=ignore, changed_only=pchanged,
                cache_dir=pcache)
            plines = {v.path: _read_lines(v.path) for v in got.violations}
        finally:
            os.chdir(jcwd)
        jlines = {v.path: _read_lines(v.path) for v in want.violations}
        assert [self.key(v) for v in got.violations] == [
            self.expect(v, jlines[v.path]) for v in want.violations]
        assert (got.n_files, got.n_linted, got.n_cached) == (
            want.n_files, want.n_linted, want.n_cached)
        self.calls += 1
        self._tally(self._codes_run(tuple(rules) + tuple(project_rules),
                                    select, ignore), got.violations)
        return dataclasses.replace(got, violations=[
            self.back(v, plines[v.path]) for v in got.violations])

    def fix_source(self, source, violations):
        want = self.originals["fix_source"](source, violations)
        jlines = source.splitlines()
        fixed, n = pfixes.fix_source(
            swap(source), [self.forward(v, jlines) for v in violations])
        assert (unswap(fixed), n) == want
        self.calls += 1
        return want

    def install(self, monkeypatch) -> None:
        self.originals = {"lint_source": jengine.lint_source,
                          "lint_tree": jproject.lint_tree,
                          "fix_source": jfixes.fix_source}
        for mod in (jengine, jan):
            monkeypatch.setattr(mod, "lint_source", self.lint_source)
        for mod in (jproject, jan):
            monkeypatch.setattr(mod, "lint_tree", self.lint_tree)
        monkeypatch.setattr(jfixes, "fix_source", self.fix_source)


def _tests_of(module) -> dict:
    return {name: fn for name, fn in vars(module).items()
            if name.startswith("test_") and inspect.isfunction(fn)}


#: JAX tests that read the JAX package's own tree or make no analyzer
#: call, and where the port's counterpart runs
NOT_RULE_CASES = {
    "test_committed_tree_lints_clean":
        "test_torch_analysis_port.py: the port's tree lints clean",
    "test_committed_baseline_carries_no_grandfathered_debt":
        "test_torch_analysis_port.py: the port's baseline is empty",
    "test_tda051_real_tree_and_baseline_stay_clean":
        "test_torch_analysis_port.py: the port's tree lints clean",
    "test_metric_contract_collector_matches_bench":
        "the port has no bench.py yet (ROADMAP A13)",
    "test_lint_graph_seconds_stays_interactive":
        "a timing pin on the JAX package's tree (a reference failure, "
        "ROADMAP C); chip_smoke.py phase 20 prints the port's",
    "test_protocol_check_matches_committed_doc":
        "test_torch_analysis_port.py: protocol --check",
    "test_protocol_json_renders_the_cluster_contract":
        "test_torch_analysis_port.py: protocol --format json",
    "test_git_changed_is_cwd_relative_from_subdir":
        "test_git_changed_is_cwd_relative_in_both_packages below",
    "test_every_shipped_rule_has_code_and_invariant":
        "test_rule_tables_are_jaxs_with_the_name_swapped below",
    "test_project_rules_have_codes_and_invariants":
        "test_rule_tables_are_jaxs_with_the_name_swapped below",
}

#: the TDA120 cases of tests/test_tune.py
TUNE_CASES = ("test_tda120_flags_offtable_pins_in_scoped_trees",
              "test_tda120_reasoned_pin_escape",
              "test_tda120_full_tree_baseline_is_clean")

CASES = [(jcases, name) for name in _tests_of(jcases)
         if name not in NOT_RULE_CASES] \
    + [(jtune_cases, name) for name in TUNE_CASES]


def _run_case(module, name, tmp_path, monkeypatch, capsys,
              tmp_path_factory) -> Twin:
    fn = getattr(module, name)
    twin = Twin(tmp_path, tmp_path_factory.mktemp("port"))
    twin.install(monkeypatch)
    fixtures = {"tmp_path": tmp_path, "monkeypatch": monkeypatch,
                "capsys": capsys}
    fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})
    return twin


@pytest.mark.parametrize("module,name", CASES,
                         ids=[name for _, name in CASES])
def test_rule_case_gives_jaxs_findings(module, name, tmp_path, monkeypatch,
                                       capsys, tmp_path_factory):
    twin = _run_case(module, name, tmp_path, monkeypatch, capsys,
                     tmp_path_factory)
    assert twin.calls, f"{name} made no analyzer call"


def test_every_jax_analysis_test_is_a_case_or_named():
    """A test added to ``tests/test_analysis.py`` becomes a case here,
    unless it is named in :data:`NOT_RULE_CASES`."""
    names = set(_tests_of(jcases))
    assert set(NOT_RULE_CASES) <= names
    assert {n for m, n in CASES if m is jcases} \
        == names - set(NOT_RULE_CASES)
    assert set(TUNE_CASES) <= set(_tests_of(jtune_cases))


def test_every_code_fires_and_stays_clean_in_some_case(capsys,
                                                       tmp_path_factory):
    """Over all the cases, each code of the port's analyzer (TDA000
    included) fires in one and runs clean in another."""
    fired, clean = set(), set()
    for module, name in CASES:
        tmp = tmp_path_factory.mktemp("case")
        with pytest.MonkeyPatch.context() as mp:
            cwd = os.getcwd()
            try:
                twin = _run_case(module, name, tmp, mp, capsys,
                                 tmp_path_factory)
            finally:
                os.chdir(cwd)
        fired |= twin.fired
        clean |= twin.clean
    codes = {r.code for r in pan.RULES + pan.PROJECT_RULES} | {"TDA000"}
    assert codes - fired == set()
    assert codes - clean == set()


def test_rule_tables_are_jaxs_with_the_name_swapped():
    """Every rule keeps its code, name and invariant (the package name
    swapped); the tables are sorted and the project family is the same
    nine codes."""
    for jrules, prules in ((jan.RULES, pan.RULES),
                           (jan.PROJECT_RULES, pan.PROJECT_RULES)):
        assert [(r.code, r.name, swap(r.invariant)) for r in jrules] \
            == [(r.code, r.name, r.invariant) for r in prules]
        assert [r.code for r in prules] == sorted({r.code for r in prules})
    for rule in pan.RULES + pan.PROJECT_RULES:
        assert pengine.CODE_RE.match(rule.code)
        assert rule.invariant and rule.name
    for rule in pan.PROJECT_RULES:
        assert rule.check(None) == ()


def test_geometry_tables_of_tda120_are_equal():
    """TDA120 reads each package's own ``tune/defaults.GEOMETRY_KNOBS``;
    the two tables spell the same values."""
    from tpu_distalg.tune import defaults as jd
    from tpu_distalg_torch.tune import defaults as pd

    assert pd.GEOMETRY_KNOBS == jd.GEOMETRY_KNOBS


def test_git_changed_is_cwd_relative_in_both_packages(tmp_path,
                                                      monkeypatch):
    import subprocess

    from tpu_distalg.analysis import cli as jcli
    from tpu_distalg_torch.analysis import cli as pcli

    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "mod.py").write_text("x = 1\n")
    subprocess.run(["git", "init", "-q", str(tmp_path)], check=True)
    monkeypatch.chdir(tmp_path / "pkg")
    assert pcli._git_changed() == jcli._git_changed() == {"mod.py"}
