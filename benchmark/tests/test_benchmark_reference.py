"""The plain reference against the port's CPU path at a tiny size, and
its independence from the program."""

import ast
import os

import numpy as np
import pytest
import torch

from conftest import BENCH_DIR
from reference import draws, follow, lr, threefry

PRECISION = {"rows": "bfloat16", "forward_weights": "bfloat16",
             "residual": "bfloat16"}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 + 3])
def test_threefry_words_equal_the_port(seed):
    from tpu_distalg_torch.utils import prng

    k = threefry.seed_key(seed, "cpu")
    assert torch.equal(k, prng.root_key(seed))
    ts = torch.arange(0, 40)
    assert torch.equal(threefry.fold(k, ts), prng.fold_in(k, ts))
    kk = threefry.fold(k, ts)
    assert torch.equal(threefry.words(kk, 300), prng.bits(kk, (300,)))


def test_step_draws_equal_the_port():
    from tpu_distalg_torch.ops import sampling
    from tpu_distalg_torch.utils import prng

    ids = draws.step_draws(12345, 3, 50, 391, 39, "cpu", chunk=16)
    keys = prng.fold_in(prng.root_key(12345), torch.arange(3, 53))
    port = sampling.sample_block_ids(keys, 1, 391, 39)[:, 0]
    assert torch.equal(ids, port.to(torch.int64))


def test_round_draws_equal_the_port():
    from tpu_distalg_torch.models import local_sgd

    cfg = local_sgd.LocalSGDConfig(seed=99, n_local_iterations=5)
    port = local_sgd.block_draws(cfg, 4, 64, 6, torch.arange(10, 30))
    ids = draws.round_draws(99, 10, 20, 4, 64, 6, "cpu", chunk=7)
    assert torch.equal(ids - torch.arange(4)[:, None] * 64,
                       port[:, 0].to(torch.int64))


def _task(n=6000, f=6, seed=3):
    r = np.random.default_rng(seed)
    X = np.concatenate([r.normal(size=(n, f)), np.ones((n, 1))],
                       axis=1).astype(np.float32)
    y = (r.random(n) < 0.5).astype(np.float32)
    return X, y, (r.random(f + 1) * 2 - 1).astype(np.float32)


def test_ssgd_follow_equals_the_port_cpu_path():
    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import get_mesh

    X, y, w0 = _task()
    mesh = get_mesh(data=1, device="cpu")
    cfg = ssgd.SSGDConfig(n_iterations=10, mega_steps=5, eval_every=5,
                          sampler="fused_train", x_dtype="bfloat16",
                          gather_block_rows=64, seed=4321)
    _, X2, _, meta = ssgd.prepare_fused(X, y, mesh, cfg)
    w = torch.zeros(meta["d_total"])
    w[:7] = torch.from_numpy(w0)
    X_te = torch.zeros((10, meta["d_total"]))
    port = ssgd.train_prepared(mesh, cfg, X2, w, meta, X_te,
                               torch.zeros(10)).w[:7]
    nb = draws.blocks_per_replica(6000, 64)
    rows = lr.Rows(torch.from_numpy(X), torch.from_numpy(y), 64, PRECISION)
    (ref,), _ = follow.ssgd(rows, torch.from_numpy(w0), [(4321, 10)],
                            n_blocks=nb, n_sampled=draws.sampled_blocks(
                                nb, 0.1), eta=0.1, precision=PRECISION)
    torch.testing.assert_close(port, ref, rtol=1e-5, atol=1e-6)


def test_model_average_follow_equals_the_port_cpu_path():
    from tpu_distalg_torch.models import local_sgd
    from tpu_distalg_torch.parallel import get_mesh

    X, y, w0 = _task(n=8192)
    mesh = get_mesh(data=4, device="cpu")
    cfg = local_sgd.LocalSGDConfig(n_iterations=4, sampler="fused_train",
                                   x_dtype="bfloat16", gather_block_rows=64,
                                   seed=77)
    fn, X2, _, _, _, meta = local_sgd.prepare_fused(X, y, mesh, cfg)
    d_t = meta["d_total"]
    w = torch.zeros(d_t)
    w[:7] = torch.from_numpy(w0)
    port = fn(X2, torch.zeros((10, d_t)), torch.zeros(10), w,
              torch.zeros((4, d_t)), torch.zeros(d_t), t0=2)[0][:7]
    nb = draws.blocks_per_replica(8192, 64, 4)
    rows = lr.Rows(torch.from_numpy(X), torch.from_numpy(y), 64, PRECISION)
    (ref,), _ = follow.model_average(
        rows, torch.from_numpy(w0), seed=77, t0=2, rounds=4, replicas=4,
        local_steps=5, n_blocks=nb, n_sampled=draws.sampled_blocks(nb, 0.1),
        eta=0.1, precision=PRECISION, record={4})
    torch.testing.assert_close(port, ref, rtol=1e-5, atol=1e-6)


def test_reference_imports_nothing_of_the_program():
    seen = set()
    folder = os.path.join(BENCH_DIR, "reference")
    for name in os.listdir(folder):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(folder, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                seen.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                seen.add(node.module.split(".")[0])
    assert seen <= {"__future__", "torch", "reference", "statistics"}, seen


def test_lower_precision_rounds_coarser():
    x = torch.linspace(-3, 3, 1001)
    e_bf16 = (lr.rounded(x, "bfloat16") - x.double()).abs().max()
    e_fp8 = (lr.rounded(x, "float8_e4m3fn") - x.double()).abs().max()
    assert e_fp8 > 8 * e_bf16 > 0
