"""The port's analyzer over the JAX package's whole lint surface.

``tpu_distalg/``, ``tests/``, ``scripts/`` and ``bench.py`` are copied
into a temporary tree with ``tpu_distalg`` read as ``tpu_distalg_torch``
everywhere (paths and text). The JAX analyzer runs over the original,
the port's over the copy, and both report RAW findings: every per-file
and project rule's output before suppressions and baseline, the TDA000
marker findings included, so the comparison is of real findings and
not of two empty lists (the JAX tree's reasoned suppressions alone
cover a few dozen).

Compared keys: code, path, line, column, message, snippet and statement
end, with the name swapped. A column moves by the six characters of
``_torch`` for each swapped name before it on its line. The wire
contract extracted from each tree is compared the same way.
"""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import re

import pytest

from tpu_distalg.analysis import engine as jengine
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = pathlib.Path(__file__).resolve().parent.parent
SURFACE = ("tpu_distalg", "tests", "scripts", "bench.py")
JAX_NAME = re.compile(r"\btpu_distalg\b")


def _swap(text: str) -> str:
    return JAX_NAME.sub("tpu_distalg_torch", text)


def raw_findings(pkg: str, files) -> tuple:
    """``(findings, project)``: the analyzer of ``pkg`` over ``files``
    (cwd-relative) before suppressions, and its project graph."""
    an = importlib.import_module(f"{pkg}.analysis")
    engine = importlib.import_module(f"{pkg}.analysis.engine")
    project = importlib.import_module(f"{pkg}.analysis.project")
    found, sources, contexts = [], {}, {}
    for f in files:
        p = engine.norm_path(f)
        with open(f, encoding="utf-8") as fh:
            sources[p] = fh.read()
        try:
            ctx = engine.make_context(sources[p], f)
        except SyntaxError as e:
            found.append(engine.syntax_violation(f, e))
            continue
        contexts[p] = ctx
        for rule in an.RULES:
            if rule.applies(ctx):
                found.extend(rule.check(ctx))
        found.extend(engine.marker_violations(ctx))
    graph, _ = project.build_project(files, sources=sources,
                                     contexts=contexts)
    for rule in an.PROJECT_RULES:
        found.extend(rule.check_project(graph))
    return found, graph


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Both analyzers' raw findings and contracts, built once."""
    copy = tmp_path_factory.mktemp("surface")
    cwd = os.getcwd()
    try:
        os.chdir(REPO)
        files = jengine.iter_python_files(
            [p for p in SURFACE if os.path.exists(p)])
        jfound, jgraph = raw_findings("tpu_distalg", files)
        jlines = {}
        for f in files:
            text = (REPO / f).read_text(encoding="utf-8")
            jlines[jengine.norm_path(f)] = text.splitlines()
            dst = copy / _swap(f)
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_text(_swap(text), encoding="utf-8")
        from tpu_distalg.analysis import protocol as jprotocol

        jcontract = jprotocol.render_json(jprotocol.build_contract(jgraph))
        os.chdir(copy)
        pfound, pgraph = raw_findings("tpu_distalg_torch",
                                      [_swap(f) for f in files])
        from tpu_distalg_torch.analysis import protocol as pprotocol

        pcontract = pprotocol.render_json(pprotocol.build_contract(pgraph))
    finally:
        os.chdir(cwd)
    return {"files": files, "jax": jfound, "port": pfound,
            "jlines": jlines,
            "jcontract": jcontract, "pcontract": pcontract}


def _expected(v, jlines) -> tuple:
    line = jlines[v.path][v.line - 1] if v.line <= len(jlines[v.path]) \
        else ""
    col = v.col + len("_torch") * len(JAX_NAME.findall(line[:v.col]))
    return (v.code, _swap(v.path), v.line, col, _swap(v.message),
            _swap(v.snippet), v.end_line)


def _key(v) -> tuple:
    return (v.code, v.path, v.line, v.col, v.message, v.snippet,
            v.end_line)


def test_raw_findings_over_jaxs_surface_are_jaxs(trees):
    want = sorted(_expected(v, trees["jlines"]) for v in trees["jax"])
    got = sorted(_key(v) for v in trees["port"])
    assert got == want
    # the comparison is of findings, per-file and project alike
    codes = {k[0] for k in want}
    assert {"TDA001", "TDA100", "TDA112"} <= codes
    assert len(want) >= 30


def test_contract_over_jaxs_surface_is_jaxs(trees):
    want = json.loads(_swap(json.dumps(trees["jcontract"],
                                       sort_keys=True)))
    assert trees["pcontract"] == want
    assert len(want["frames"]) >= 10
