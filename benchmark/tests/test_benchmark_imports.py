"""The check that nothing of JAX or the JAX package is loaded: top-level
names compared whole."""

import os
import subprocess
import sys
import types

import pytest

from conftest import BENCH_DIR, ROOT
from harness import imports


def test_whole_top_level_names():
    assert imports.forbidden(["tpu_distalg_torch", "tpu_distalg_torch.ops",
                              "jaxtyping", "flaxen", "torch"]) == []
    assert imports.forbidden(["tpu_distalg.models.ssgd"]) == ["tpu_distalg"]
    assert imports.forbidden(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def test_a_run_with_jax_loaded_fails(run_tiny, monkeypatch):
    from harness.cell import ForbiddenImport

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(ForbiddenImport, match="jax"):
        run_tiny("tiny-lr.ssgd")


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import calibrate, run\n"
            "from harness import cell, data, trace, program\n"
            "from tpu_distalg_torch.models import ssgd, local_sgd\n"
            "import importlib.util as u\n"
            "for d in ('drivers', 'metrics'):\n"
            "    import os\n"
            "    for n in os.listdir(os.path.join(%r, d)):\n"
            "        if n.endswith('.py'):\n"
            "            s = u.spec_from_file_location(n[:-3], "
            "os.path.join(%r, d, n))\n"
            "            s.loader.exec_module(u.module_from_spec(s))\n"
            "from harness.imports import forbidden\n"
            "print(forbidden())\n") % (ROOT, BENCH_DIR, BENCH_DIR, BENCH_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine "
                    "without one")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
         "higgs-lr.ssgd", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
