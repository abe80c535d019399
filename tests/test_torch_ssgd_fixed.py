"""SSGD's last two resident data paths in the port, against the JAX
package: the ``fixed`` sampler (``tpu_distalg_torch/models/ssgd.py``,
``ops/sampling.fixed_row_ids``) and ``prepare_fused_synthetic`` (the
two-class rows made on the device, ``utils/datasets.
synthetic_two_class_rows``).

Standards. Drawn row ids and the synthesis's integer-valued columns
(bias, valid, padding) are exact. Weights after 60 ``fixed`` steps are
within 1e-4 of their largest entry with equal accuracy histories (the
standard ``tests/test_torch_ssgd.py`` holds SSGD to; both packages
gather the same rows and add in different orders). The 1500-step breast-cancer run on 8 shards ends
above 0.91, as ``tests/test_optimizers.py:128`` asserts for the JAX
package (both end at 0.918129; their float32 histories part at step
401). Synthetic X is held within 1e-6 absolute and relative plus 4 ulp
of its uniform carried through erfinv's slope (see
``tests/test_torch_monte_carlo.py``); y equal apart from rows whose
margin lies within 1e-4 of 0, which are counted. 20 ``fused_gather``
steps on JAX's own X2, carried across through numpy, are within 1e-5
of the largest weight beside JAX's interpret-mode run.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_distalg.models import ssgd as jssgd
from tpu_distalg.utils import datasets as jdatasets
from tpu_distalg.utils import prng as jprng
from tpu_distalg_torch.models import ssgd
from tpu_distalg_torch.ops import sampling
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import datasets, prng
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARGIN = 1e-4


@pytest.fixture(scope="module")
def data():
    return datasets.breast_cancer_split()


@pytest.fixture(scope="module")
def jmeshes():
    from tpu_distalg.parallel import get_mesh as jget_mesh

    return {n: jget_mesh(data=n) for n in (1, 2, 4, 8)}


def _normal_tol(v: np.ndarray) -> np.ndarray:
    slope = np.sqrt(np.pi / 2) * np.exp(np.minimum(
        v.astype(np.float64) ** 2 / 2, 80.0))
    return 1e-6 * (1 + np.abs(v)) + 4 * 2.0**-24 * slope


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_fixed_row_ids_equal_jax(n_shards):
    """Each shard's rows: the head of permutation(fold_in(fold_in(key,
    t), shard), n_local), as ``ssgd.py:1380-1385`` draws them."""
    n_local = -(-398 // n_shards)
    b = max(1, round(0.1 * n_local))
    kj, kt = jprng.root_key(42), prng.root_key(42)
    for t in (0, 1, 59, 1499):
        got = sampling.fixed_row_ids(kt, t, n_shards, n_local, b).numpy()
        for s in range(n_shards):
            k = jax.random.fold_in(jax.random.fold_in(kj, t), s)
            want = np.asarray(jax.random.permutation(k, n_local))[:b]
            np.testing.assert_array_equal(got[s], want)


def test_fixed_row_ids_past_one_shuffle_round_equal_jax():
    """n_local past 1625 takes two rounds of the stable sort."""
    kj, kt = jprng.root_key(3), prng.root_key(3)
    got = sampling.fixed_row_ids(kt, 7, 2, 100_000, 10_000).numpy()
    for s in range(2):
        k = jax.random.fold_in(jax.random.fold_in(kj, 7), s)
        np.testing.assert_array_equal(
            got[s], np.asarray(jax.random.permutation(k, 100_000))[:10_000])


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_fixed_60_steps_match_jax(data, jmeshes, n_shards):
    cfg = ssgd.SSGDConfig(n_iterations=60, sampler="fixed")
    got = ssgd.train(*data, get_mesh(n_shards, device="cpu"), cfg)
    want = jssgd.train(*data, jmeshes[n_shards],
                       jssgd.SSGDConfig(**dataclasses.asdict(cfg)))
    w_j = np.asarray(want.w)
    np.testing.assert_allclose(got.w.numpy(), w_j, rtol=0,
                               atol=1e-4 * float(np.abs(w_j).max()))
    np.testing.assert_array_equal(got.accs.numpy(), np.asarray(want.accs))


def test_fixed_breast_cancer_on_eight_shards(data):
    res = ssgd.train(*data, get_mesh(8, device="cpu"),
                     ssgd.SSGDConfig(n_iterations=1500, sampler="fixed"))
    assert res.final_acc > 0.91


def test_fixed_segmented_equals_straight(data, tmp_path):
    cfg = ssgd.SSGDConfig(n_iterations=50, sampler="fixed")
    mesh = get_mesh(2, device="cpu")
    straight = ssgd.train(*data, mesh, cfg)
    seg = ssgd.train(*data, mesh, cfg, checkpoint_dir=str(tmp_path / "ck"),
                     checkpoint_every=20)
    assert torch.equal(seg.w, straight.w)
    assert torch.equal(seg.accs, straight.accs)


@pytest.mark.parametrize("change,match", [
    (dict(use_pallas=True), "use_pallas"),
    (dict(comm="int8"), "legacy gather path"),
    (dict(sync="ssp:4"), "stay BSP"),
    (dict(feature_sharded=True), "feature_sharded composes"),
])
def test_fixed_refusals_in_jax_words(data, jmeshes, change, match):
    """The JAX package's refusals of ``fixed``, in its words, and not the
    port's A9 refusals (``tests/test_checkpoint_resume.py:81``); the
    feature_sharded refusal names the port's plain-torch path where
    JAX's names its XLA builder."""
    msgs = []
    for run, cfg, mesh in (
            (ssgd.train, ssgd.SSGDConfig(n_iterations=5, sampler="fixed",
                                         **change),
             get_mesh(1, device="cpu")),
            (jssgd.train, jssgd.SSGDConfig(n_iterations=5, sampler="fixed",
                                           **change), jmeshes[1])):
        with pytest.raises(ValueError, match=match) as ei:
            run(*data, mesh, cfg)
        msgs.append(str(ei.value).replace("(plain torch)",
                                          "(this XLA builder)"))
    assert msgs[0] == msgs[1]


def test_virtual_still_names_a10(data, jmeshes):
    """The ``virtual`` sampler (A10, now ``models/ssgd_virtual.py``) is
    refused by ``ssgd.train`` as the JAX package refuses it."""
    with pytest.raises(ValueError) as got:
        ssgd.train(*data, get_mesh(1, device="cpu"),
                   ssgd.SSGDConfig(n_iterations=5, sampler="virtual"))
    with pytest.raises(ValueError) as want:
        jssgd.train(*data, jmeshes[1],
                    jssgd.SSGDConfig(n_iterations=5, sampler="virtual"))
    assert str(got.value) == str(want.value)


def test_cli_ssgd_fixed_runs_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
         "ssgd", "--sampler", "fixed", "--n-slices", "2", "--n-iterations",
         "100", "--quiet"], capture_output=True, text=True, timeout=300,
        env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "Final acc: " in out.stdout and "[ssgd] 100 iterations" in \
        out.stdout


def _synth_cfgs(**kw):
    base = dict(sampler="fused_gather", fused_pack=4, gather_block_rows=32,
                n_iterations=20, eval_test=False, **kw)
    return ssgd.SSGDConfig(**base), jssgd.SSGDConfig(**base)


def _exempt(ids: np.ndarray, n_features: int, seed: int) -> np.ndarray:
    """Rows of |margin| <= MARGIN, from JAX's draws."""
    key = jprng.root_key(seed)
    k_w, k_rows = jax.random.fold_in(key, 0), jax.random.fold_in(key, 1)
    X, _ = jdatasets.synthetic_two_class_rows(n_features, seed)(
        jnp.asarray(ids, jnp.int32))
    w = jax.random.normal(k_w, (n_features,))
    noise = jax.vmap(lambda i: jax.random.logistic(jax.random.fold_in(
        jax.random.fold_in(k_rows, i), 7)))(jnp.asarray(ids, jnp.int32))
    margin = np.asarray(X @ w) * (2.0 / np.sqrt(n_features)) + \
        np.asarray(noise)
    return np.abs(margin) <= MARGIN


@pytest.mark.parametrize("n_features,seed", [(30, 0), (6, 3)])
def test_synthetic_rows_match_jax(n_features, seed):
    ids = np.concatenate([np.arange(5000), np.arange(99_990_000,
                                                     99_995_000)])
    Xj, yj = jax.jit(jdatasets.synthetic_two_class_rows(n_features, seed))(
        jnp.asarray(ids, jnp.int32))
    Xt, yt = datasets.synthetic_two_class_rows(n_features, seed)(
        torch.from_numpy(ids))
    Xj = np.asarray(Xj)
    assert Xt.dtype == torch.float32 and Xt.shape == Xj.shape
    assert (np.abs(Xt.numpy() - Xj) <= _normal_tol(Xj)).all()
    same = yt.numpy() == np.asarray(yj)
    exempt = _exempt(ids, n_features, seed)
    assert (same | exempt).all() and exempt.sum() <= 2


@pytest.mark.parametrize("n_shards", [1, 8])
def test_prepare_fused_synthetic_matches_jax(jmeshes, n_shards):
    """The layout as ``tests/test_parallel_core.py:125`` holds JAX's;
    meta and w0 equal; bias, valid and padding columns exact, X within
    the tolerance, y equal apart from the exempt rows."""
    n, nf = 900, 6
    cfg, jcfg = _synth_cfgs(x_dtype="float32")
    _, X2, w0, meta = ssgd.prepare_fused_synthetic(
        n, nf, get_mesh(n_shards, device="cpu"), cfg)
    _, jX2, jw0, jmeta = jssgd.prepare_fused_synthetic(
        n, nf, jmeshes[n_shards], jcfg)
    assert meta == jmeta
    np.testing.assert_array_equal(w0.numpy(), np.asarray(jw0))
    flat = X2.numpy().reshape(meta["n_padded"], meta["d_total"])
    jflat = np.asarray(jX2).reshape(meta["n_padded"], meta["d_total"])
    assert meta["n_padded"] % (32 * n_shards) == 0
    np.testing.assert_array_equal(flat[:n, nf], 1.0)
    np.testing.assert_array_equal(flat[:n, meta["v_col"]], 1.0)
    np.testing.assert_array_equal(flat[n:, meta["v_col"]], 0.0)
    cols = [nf, meta["v_col"], *range(meta["v_col"] + 1, meta["d_total"])]
    np.testing.assert_array_equal(flat[:, cols], jflat[:, cols])
    assert (np.abs(flat[:, :nf] - jflat[:, :nf])
            <= _normal_tol(jflat[:, :nf])).all()
    ids = np.arange(meta["n_padded"])
    same = flat[:, meta["y_col"]] == jflat[:, meta["y_col"]]
    assert (same | _exempt(ids, nf, 0)).all()


def test_prepare_fused_synthetic_bf16_and_chunks_match_jax(jmeshes):
    """bf16 X2 (chunks halved from 256 to divide the shard's rows) equal
    to JAX's once rounded, apart from a row one bf16 ulp away."""
    cfg, jcfg = _synth_cfgs(x_dtype="bfloat16")
    _, X2, _, meta = ssgd.prepare_fused_synthetic(
        3000, 30, get_mesh(2, device="cpu"), cfg, chunk_rows=256)
    _, jX2, _, jmeta = jssgd.prepare_fused_synthetic(
        3000, 30, jmeshes[2], jcfg, chunk_rows=256)
    assert meta == jmeta and X2.dtype == torch.bfloat16
    a = X2.float().numpy()
    b = np.asarray(jX2.astype(jnp.float32))
    assert (np.abs(a - b) <= np.abs(b) * 2.0**-7).all()
    assert (a != b).mean() < 1e-3


def test_fused_gather_on_jax_synthetic_rows_matches_jax(jmeshes):
    """20 ``fused_gather`` steps (B1's plain version) on JAX's own
    synthetic X2, carried across through numpy, against JAX's run with
    its kernel in interpret mode."""
    cfg, jcfg = _synth_cfgs(x_dtype="float32")
    jfn, jX2, jw0, jmeta = jssgd.prepare_fused_synthetic(
        2000, 6, jmeshes[2], jcfg)
    dummy = jnp.zeros((1,), jnp.float32)
    ev = (jnp.zeros((1, jmeta["d_total"]), jnp.float32),
          jnp.zeros((1,), jnp.float32))
    jw, _ = jfn(jX2, dummy, dummy, *ev, jw0)
    mesh = get_mesh(2, device="cpu")
    fn = ssgd.make_train_fn_fused(mesh, cfg, jmeta)
    te = (torch.zeros((1, jmeta["d_total"])), torch.zeros((1,)))
    w, _ = fn(torch.from_numpy(np.array(jX2)), None, None, *te,
              torch.from_numpy(np.array(jw0)))
    jw = np.asarray(jw)
    np.testing.assert_allclose(w.numpy(), jw, rtol=0,
                               atol=1e-5 * float(np.abs(jw).max()))
