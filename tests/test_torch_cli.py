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

#: JAX subcommands the port has no counterpart of yet (ROADMAP A12)
MISSING_SUBCOMMANDS = {"cluster", "lint", "protocol", "tune"}
#: JAX options the port's parser rejects, by subcommand ("" = top
#: level), and the ROADMAP item each waits for
MISSING_OPTIONS = {
    "": {"--profile": "A12"},
    "kmeans": {"--plot": "A12"},
}
#: on every subcommand that has it in the JAX package, waiting for A12
MISSING_EVERYWHERE = {"--tune"}
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
