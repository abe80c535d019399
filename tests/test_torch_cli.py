"""The port's command line (``tpu_distalg_torch/cli.py``) against the JAX
package's (``tpu_distalg/cli.py``): the same subcommands and options,
with equal defaults and choices, less a named list of what the port
does not take yet. The list can only shrink: a flag the port gains
must leave it, and a flag the port lacks must be on it.

JAX builds its parser inside ``main()``; the test takes it by patching
``argparse.ArgumentParser.parse_args`` for the one call.
"""

from __future__ import annotations

import argparse
import os

import pytest

from tpu_distalg import cli as jcli
from tpu_distalg_torch import cli
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

#: JAX subcommands the port has no counterpart of yet: ``lint`` and
#: ``protocol`` (ROADMAP A12.7)
MISSING_SUBCOMMANDS = {"lint", "protocol"}
#: JAX options the port's parser rejects, by subcommand ("" = top
#: level), and the ROADMAP item each waits for
MISSING_OPTIONS: dict = {}
#: options missing on every subcommand that has them in the JAX package
MISSING_EVERYWHERE: set = set()
#: options the port has and the JAX package does not
PORT_ONLY = {"": {"--device"}, "als": {"--seed"}}


class _Captured(Exception):
    pass


def _jax_parser(monkeypatch) -> argparse.ArgumentParser:
    def grab(self, *args, **kwargs):
        raise _Captured(self)

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Captured) as got:
            jcli.main([])
    return got.value.args[0]


def _options(parser) -> tuple[dict, dict]:
    """``(top-level options, {subcommand: options})``, each option
    ``{long flag: (default, choices)}``."""
    top, subs = {}, {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sp in action.choices.items():
                subs[name] = _options(sp)[0]
        elif action.option_strings and action.dest != "help":
            flag = max(action.option_strings, key=len)
            choices = (None if action.choices is None
                       else sorted(map(str, action.choices)))
            top[flag] = (action.default, choices)
    return top, subs


def test_port_options_equal_jax_but_the_named_gaps(monkeypatch):
    jtop, jsubs = _options(_jax_parser(monkeypatch))
    ptop, psubs = _options(cli._parser())
    assert set(jsubs) - set(psubs) == MISSING_SUBCOMMANDS
    assert not set(psubs) - set(jsubs)
    for name in sorted(set(psubs)) + [""]:
        jopts, popts = (jtop, ptop) if name == "" else (jsubs[name],
                                                        psubs[name])
        missing = set(MISSING_OPTIONS.get(name, {}))
        if name:
            missing |= MISSING_EVERYWHERE & set(jopts)
        assert set(jopts) - set(popts) == missing, name
        assert set(popts) - set(jopts) == PORT_ONLY.get(name, set()), name
        for flag in sorted(set(jopts) & set(popts)):
            assert popts[flag] == jopts[flag], (name, flag)


def test_pagerank_engine_flags_take_jax_defaults():
    """The four flags of the graph engine parse with the JAX CLI's
    defaults (``tpu_distalg/cli.py:343-371``)."""
    args = cli._parser().parse_args(["pagerank"])
    assert (args.stream_cache, args.block_edges, args.combine,
            args.edge_capacity) == (None, 65536, "auto", 16777216)
    args = cli._parser().parse_args(
        ["pagerank", "--data-backend", "virtual", "--stream-cache", "p",
         "--block-edges", "64", "--combine", "sparse", "--edge-capacity",
         "9"])
    assert (args.data_backend, args.stream_cache, args.block_edges,
            args.combine, args.edge_capacity) == ("virtual", "p", 64,
                                                  "sparse", 9)


@pytest.mark.parametrize("args,item", [
    (["--role", "replica"], "needs --artifact"),
    (["--role", "router"], "needs --replicas"),
    (["--ps-mode", "rowstore", "--sync", "bsp"], "stale-synchronous"),
    (["--fault-plan", "seed=1;cluster:replica@0=kill", "--sync", "bsp"],
     "stale-synchronous"),
    (["--sync", "bsp"], "stale-synchronous"),
    (["--max-restarts", "1"], "launcher"),
    (["--role", "worker"], "--connect"),
    (["--fault-plan", "seed=1;segment:run@0=kill"], "reads no rule"),
])
def test_cluster_refusals(args, item):
    """A replica with no artifact, a router with no replicas, a BSP
    cluster (with the row store and with a ``cluster:replica`` rule,
    both of which pass the parser and the plan check), a restart
    budget, a worker with no address and a plan no seam of the cluster
    reads are refused."""
    with pytest.raises(SystemExit, match=item):
        cli.main(["--device", "cpu", "cluster", *args])


def test_cluster_coordinator_and_worker_roles(tmp_path):
    """``--role coordinator`` prints its address, a ``--role worker``
    process joins it on the CPU, and each prints its JAX-CLI line; the
    digest is the thread-mode launcher's."""
    import json
    import subprocess
    import sys

    from tpu_distalg_torch import cluster as clus

    env = dict(os.environ, TDA_TELEMETRY_DIR="", TDA_FAULT_PLAN="")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = [sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
            "cluster"]
    coord = subprocess.Popen(
        base + ["--role", "coordinator", "--workers", "1", "--n-windows",
                "3", "--sync", "ssp:2", "--n-rows", "256", "--deadline",
                "120"], env=env, cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        first = coord.stdout.readline().strip()
        prefix = "cluster_coordinator: listening on "
        assert first.startswith(prefix), (first, coord.stderr.read())
        addr = first[len(prefix):]
        wk = subprocess.run(base + ["--role", "worker", "--connect", addr],
                            env=env, cwd=repo, capture_output=True,
                            text=True, timeout=120)
        assert wk.returncode == 0, wk.stderr
        stats = json.loads(wk.stdout.strip().splitlines()[-1][
            len("cluster_worker: "):])
        assert stats["pushes"] == 3 and stats["windows"] == 3
        out, err = coord.communicate(timeout=120)
    finally:
        if coord.poll() is None:
            coord.kill()
            coord.wait()
    assert coord.returncode == 0, err
    line = out.strip().splitlines()[-1]
    res = json.loads(line[len("cluster_result: "):])
    want = clus.run_local_cluster(
        clus.ClusterConfig(n_slots=1, n_windows=3, staleness=2,
                           train=clus.TrainTask(n_rows=256)),
        spawn="thread", device="cpu")
    assert (res["version"], res["merges"]) == (3, 3)
    assert res["event_digest"] == clus.event_digest(want)
