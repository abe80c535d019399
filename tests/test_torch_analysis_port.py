"""The port's own tree under its analyzer, and ``lint`` / ``protocol`` on
the port's command line (``python -m tpu_distalg_torch.cli``).

The committed tree (the package, ``tests/`` and ``chip_smoke.py``)
lints clean with the port's baseline, which holds no entries; its wire
contract is ``tpu_distalg_torch/PROTOCOL.md`` and, with ``tpu_distalg/``
read as ``tpu_distalg_torch/``, the JAX package's ``docs/PROTOCOL.md``
row for row (the preamble names the port's command and file). The
command line: exit codes 0, 1 and 2, ``--format json|md``, ``--fix``,
``--changed``, ``--update-baseline`` (to the port's baseline, never the
repo root's ``lint_baseline.json``, which is the JAX package's), and the
``lint`` / ``protocol`` spans and counters under ``--telemetry-dir``,
on small trees under ``tmp_path``. Violating sources live in strings
only.
"""

from __future__ import annotations

import json
import os
import pathlib
import textwrap

import pytest

from tpu_distalg_torch import cli
from tpu_distalg_torch.analysis import baseline as blmod
from tpu_distalg_torch.analysis import cli as lint_cli
from tpu_distalg_torch.telemetry import events as tevents
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = pathlib.Path(__file__).resolve().parent.parent

VIOLATING = """\
import time


def stamp():
    return time.time()
"""

CLEAN = """\
import time


def stamp():
    return time.monotonic()
"""

TRAINER = """
import dataclasses


@dataclasses.dataclass
class TrainCarry:
    w: list
    acc: float
    res: list


def step(carry):
    carry.w = [x - 1 for x in carry.w]
    carry.acc = 0.5
    carry.res = [x * 2 for x in carry.res]
    return carry
"""

CKPT_DROPS_RES = """
from miniproj.trainer import TrainCarry


def payload(c: TrainCarry) -> dict:
    return {"w": c.w, "acc": c.acc}
"""

#: a one-kind wire: a request, its handler and its reply
WIRE = {
    "miniproj/__init__.py": "",
    "miniproj/transport.py": """
def send_frame(sock, kind, meta, arrays=()):
    raise NotImplementedError


def request(sock, kind, meta, arrays=()):
    raise NotImplementedError


def recv_frame(sock):
    raise NotImplementedError
""",
    "miniproj/client.py": """
from miniproj import transport


def ask(sock):
    kind, meta, _ = transport.request(sock, "ping", {"n": 1})
    if kind != "pong":
        raise RuntimeError(kind)
    return meta["n"]
""",
    "miniproj/server.py": """
from miniproj import transport


def serve(conn):
    kind, meta, _ = transport.recv_frame(conn)
    if kind == "ping":
        transport.send_frame(conn, "pong", {"n": meta["n"]})
""",
}


@pytest.fixture(autouse=True)
def _no_ambient_telemetry(monkeypatch):
    monkeypatch.delenv("TDA_TELEMETRY_DIR", raising=False)
    yield
    tevents.configure(False)


def _write(root: pathlib.Path, files: dict) -> None:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def _events(tdir: pathlib.Path) -> list:
    tevents.configure(False)   # close the sink so the log is flushed
    out = []
    for p in sorted(tdir.glob("events-*.jsonl")):
        with open(p) as f:
            out.extend(json.loads(line) for line in f if line.strip())
    return out


# ---------------------------------------------------------------------
# the committed tree


@pytest.fixture(scope="module")
def committed_lint():
    """One lint of the port's default surface from the repo root (the
    graph cache it leaves serves ``protocol`` below)."""
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        from contextlib import redirect_stdout
        from io import StringIO

        buf = StringIO()
        with redirect_stdout(buf):
            rc = cli.main(["lint", "--no-ruff", "--format", "json"])
    finally:
        os.chdir(cwd)
    return rc, json.loads(buf.getvalue())


def test_committed_tree_lints_clean(committed_lint):
    """The package, the tests and chip_smoke.py: no finding, none
    baselined, the per-file pass over every file."""
    rc, doc = committed_lint
    assert rc == 0, [f"{v['path']}:{v['line']} {v['code']}"
                     for v in doc["violations"]]
    assert doc["violations"] == [] and doc["baselined"] == 0
    assert doc["files"] == doc["linted"] > 150


def test_committed_baseline_is_the_ports_and_empty():
    doc = blmod.load(str(REPO / blmod.DEFAULT_PATH))
    assert doc["entries"] == []
    assert blmod.DEFAULT_PATH == "tpu_distalg_torch/lint_baseline.json"
    assert lint_cli.DEFAULT_PATHS == ("tpu_distalg_torch", "tests",
                                      "chip_smoke.py")


def test_protocol_check_passes_on_the_committed_tree(committed_lint,
                                                    monkeypatch, capsys):
    """``protocol --check`` holds the committed PROTOCOL.md, whatever
    ``--device`` says (the analysis touches no device)."""
    monkeypatch.chdir(REPO)
    assert cli.main(["--device", "cuda", "protocol", "--check"]) == 0
    assert "tpu_distalg_torch/PROTOCOL.md matches" in capsys.readouterr().out


def _tables(text: str) -> list:
    """The document less its title and preamble: the frame and WAL
    tables and the unresolved notes."""
    lines = text.strip().splitlines()
    return lines[lines.index("## Frames"):]


def test_ports_contract_is_jaxs_with_the_root_swapped():
    """Every frame kind, sender, handler, reply, key, fence and WAL
    record of the port's tree is the JAX package's (ROADMAP C: frames
    and WAL records are byte for byte the JAX package's); only the
    preamble differs, naming the port's command and file."""
    port = (REPO / lint_cli.PROTOCOL_DOC).read_text(encoding="utf-8")
    jax = (REPO / "docs" / "PROTOCOL.md").read_text(encoding="utf-8")
    assert _tables(port) == _tables(
        jax.replace("tpu_distalg/", "tpu_distalg_torch/"))
    preamble = port.strip().splitlines()[2]
    assert "python -m tpu_distalg_torch.cli protocol --format md > " \
        "tpu_distalg_torch/PROTOCOL.md" in preamble


def test_protocol_json_renders_the_ports_cluster(committed_lint,
                                                 monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert cli.main(["protocol", "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    kinds = {row["kind"] for row in doc["frames"]}
    assert {"join", "push", "pull", "poll", "beat", "bye"} <= kinds
    assert all(s.startswith("tpu_distalg_torch/cluster/")
               for row in doc["frames"] if row["kind"] == "push"
               for s in row["senders"].split(", "))
    assert "reset" in doc["synthetics"]


# ---------------------------------------------------------------------
# the command line on small trees


def test_lint_exit_codes(tmp_path, monkeypatch, capsys):
    """0 clean, 1 on a finding, 2 on a usage error (a missing path, an
    unknown code, no default path here)."""
    monkeypatch.chdir(tmp_path)
    _write(tmp_path, {"tpu_distalg_torch/ok.py": CLEAN,
                      "tpu_distalg_torch/bad.py": VIOLATING})
    assert cli.main(["lint", "tpu_distalg_torch/ok.py", "--no-ruff"]) == 0
    assert cli.main(["lint", "tpu_distalg_torch/bad.py", "--no-ruff"]) == 1
    out = capsys.readouterr().out
    assert "tpu_distalg_torch/bad.py:5:12: TDA001 time.time()" in out
    assert cli.main(["lint", "nowhere.py", "--no-ruff"]) == 2
    assert cli.main(["lint", "tpu_distalg_torch", "--no-ruff",
                     "--select", "TDA999"]) == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.chdir(empty)
    assert cli.main(["lint", "--no-ruff"]) == 2
    assert cli.main(["protocol"]) == 2
    err = capsys.readouterr().err
    assert "no such path: nowhere.py" in err and "TDA999" in err
    assert "tpu_distalg_torch/tests/chip_smoke.py exist here" in err


def test_lint_json_schema_is_jaxs(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _write(tmp_path, {
        "tpu_distalg_torch/mod.py": VIOLATING,
        "tpu_distalg_torch/pinned.py":
            "# tda: ignore[TDA002] -- stale pin, nothing underneath\n"
            "X = 1\n"})
    assert cli.main(["lint", "tpu_distalg_torch", "--no-ruff",
                     "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert set(doc) == {"files", "linted", "cached", "graph_seconds",
                        "violations", "baselined", "stale_baseline",
                        "ruff_rc", "ruff_output"}
    assert doc["files"] == doc["linted"] == 2
    assert {v["code"] for v in doc["violations"]} == {"TDA000", "TDA001"}
    for v in doc["violations"]:
        assert set(v) == {"code", "message", "path", "line", "col",
                          "snippet", "fingerprint"}
    assert isinstance(doc["graph_seconds"], float)


def test_update_baseline_writes_the_ports_file(tmp_path, monkeypatch,
                                               capsys):
    """``--update-baseline`` with no ``--baseline`` writes
    ``tpu_distalg_torch/lint_baseline.json``, which later runs read by
    default; a fixed finding leaves its entry stale (rc 1)."""
    monkeypatch.chdir(tmp_path)
    _write(tmp_path, {"tpu_distalg_torch/mod.py": VIOLATING})
    args = ["lint", "tpu_distalg_torch/mod.py", "--no-ruff"]
    assert cli.main(args + ["--update-baseline"]) == 0
    assert not (tmp_path / "lint_baseline.json").exists()
    doc = blmod.load(str(tmp_path / blmod.DEFAULT_PATH))
    assert [e["code"] for e in doc["entries"]] == ["TDA001"]
    assert cli.main(args) == 0
    assert "1 baselined" in capsys.readouterr().out
    (tmp_path / "tpu_distalg_torch/mod.py").write_text(CLEAN)
    assert cli.main(args) == 1
    assert "stale baseline entry TDA001" in capsys.readouterr().out


def test_fix_rewrites_the_file(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _write(tmp_path, {"tests/test_mod.py": (
        "import threading\n\n"
        "def go(fn):\n"
        "    return threading.Thread(target=fn)\n")})
    assert cli.main(["lint", "tests/test_mod.py", "--no-ruff",
                     "--fix"]) == 0
    assert "threading.Thread(target=fn, daemon=False)" in (
        tmp_path / "tests/test_mod.py").read_text()
    assert "applied 1 fix(es)" in capsys.readouterr().out


def test_changed_lints_the_git_view_while_the_graph_sees_all(
        tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _write(tmp_path, {"miniproj/__init__.py": "",
                      "miniproj/trainer.py": TRAINER,
                      "miniproj/ckpt.py": CKPT_DROPS_RES,
                      "miniproj/threads.py": (
                          "import threading\n\n\ndef go():\n"
                          "    threading.Thread(target=go).start()\n")})
    monkeypatch.setattr(lint_cli, "_git_changed",
                        lambda: {"miniproj/trainer.py"})
    assert cli.main(["lint", "miniproj", "--no-ruff", "--changed"]) == 1
    out = capsys.readouterr().out
    assert "TDA100" in out and "TDA021" not in out
    assert "1 linted, graph over all" in out
    cache = tmp_path / lint_cli.CACHE_DIR / "lint_graph_torch.json"
    assert cache.exists()
    assert not (tmp_path / lint_cli.CACHE_DIR / "lint_graph.json").exists()


def test_lint_span_and_counters_under_telemetry_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write(tmp_path, {"tpu_distalg_torch/mod.py": VIOLATING})
    tdir = tmp_path / "tel"
    assert cli.main(["lint", "tpu_distalg_torch/mod.py", "--no-ruff",
                     "--telemetry-dir", str(tdir)]) == 1
    events = _events(tdir)
    spans = [e for e in events if e["ev"] == "span_end"]
    assert [(e["name"], e.get("files")) for e in spans] == [("lint", 1)]
    counters = [e for e in events if e["ev"] == "counters"][0]["counters"]
    assert counters["lint.TDA001"] == counters["lint.violations"] == 1
    assert counters["lint.files"] == 1
    gauges = {e["name"] for e in events if e["ev"] == "gauge"}
    assert "lint.graph_seconds" in gauges
    assert [e["violations"] for e in events
            if e["ev"] == "lint_summary"] == [1]


def test_protocol_formats_check_and_telemetry(tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.chdir(tmp_path)
    _write(tmp_path, WIRE)
    assert cli.main(["protocol", "miniproj", "--format", "md"]) == 0
    md = capsys.readouterr().out
    assert "| ping | miniproj/client.py | miniproj/server.py | pong |" in md
    assert cli.main(["protocol", "miniproj", "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert [(r["kind"], r["replies"]) for r in doc["frames"]] == [
        ("ping", "pong")]
    assert cli.main(["protocol", "miniproj"]) == 0
    assert "unresolved dynamic-kind send sites: 0" in \
        capsys.readouterr().out
    doc_path = tmp_path / "PROTOCOL.md"
    doc_path.write_text(md)
    tdir = tmp_path / "tel"
    assert cli.main(["protocol", "miniproj", "--check", str(doc_path),
                     "--telemetry-dir", str(tdir)]) == 0
    events = _events(tdir)
    assert [e["name"] for e in events if e["ev"] == "span_end"] == [
        "protocol"]
    # the kinds sent: ping, and pong as its reply
    assert [e["value"] for e in events if e["ev"] == "gauge"
            and e["name"] == "protocol.frame_kinds"] == [2]
    capsys.readouterr()
    doc_path.write_text(md.replace("| pong |", "| pang |"))
    assert cli.main(["protocol", "miniproj", "--check",
                     str(doc_path)]) == 1
    out = capsys.readouterr().out
    assert "python -m tpu_distalg_torch.cli protocol --format md" in out
    assert cli.main(["protocol", "miniproj", "--check"]) == 1
    assert "FAIL tpu_distalg_torch/PROTOCOL.md: unreadable" in \
        capsys.readouterr().out
