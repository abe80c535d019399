"""The out-of-core backends, the graph engine and the sequence-parallel
rings across processes (``torch.distributed`` over gloo, on the CPU)
against one process, and against the JAX package.

A spawned pair of processes, each holding 2 of 4 emulated data shards,
runs:

  * streamed SSGD (B1's plain version) over a memmap of the packed rows
    and over host memory, straight and in segments through a shared
    directory; virtual SSGD; minibatch k-means and streamed ALS on the
    resident, virtual and streamed backends. Every process opens the
    same cache (process 0 writes it first) and stages its own shards'
    blocks;
  * streamed PageRank (B7's plain version) on a 4-shard edge-block
    cache, sparse and dense combines, the streamed, virtual and resident
    backends; a run checkpointed by the pair and finished by one
    process;
  * ring attention, contiguous (causal and not) and zigzag, on the
    torch-op path and the flash path (B11 and B12's plain versions),
    outputs and the gradients of Σ out²; Ulysses on both paths; the two
    all-to-all exchanges and ``ring_allgather_matmul``.

Rank 0 also runs each on one process × 4 shards at the same thread
count (torch's CPU reductions change with it): every add keeps the
one-process order, so the two must be equal BIT FOR BIT. A group of 3
processes × 2 shards runs the zigzag rings (both paths, with gradients)
against one process × 6.

The worker is this file run as a script with the repo on ``PYTHONPATH``;
it imports neither jax nor ``tpu_distalg``. Groups meet through a
``file://`` rendezvous in ``tmp_path``; the CLI test takes free TCP
ports. Shapes: breast cancer packed 4 rows a packed row in blocks of
32, 12 steps; 4096 points of dimension 4; R 96 × 40 at rank 4; a
512-vertex power-law graph; attention at S 1024 (1536 over 6 shards),
2 heads of width 128, flash blocks of 64 queries × 128 keys (a zigzag
chunk holds one).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 240
STEPS = 12
FUSED = dict(sampler="fused_gather", gather_block_rows=32, fused_pack=4,
             shuffle_seed=0, eval_every=4, mini_batch_fraction=0.25)
BACKENDS = ("resident", "virtual", "streamed")
PL = dict(n_vertices=512, avg_in_degree=8.0, alpha=1.6, seed=3,
          block_edges=64)
SEQ, HEADS, DIM = 1024, 2, 128
#: the flash blocks: kernel B11's KV block is a multiple of 128, and a
#: zigzag chunk (S / 2n rows) must hold one
FLASH = dict(flash_block_q=64, flash_block_kv=128)
#: (name, ring_attention keywords) of the ring runs
RINGS = (
    ("ring", dict()),
    ("ring_causal", dict(causal=True)),
    ("ring_chunked", dict(causal=True, kv_chunk=64)),
    ("zigzag", dict(causal=True, layout="zigzag")),
    ("ring_flash", dict(use_flash=True)),
    ("ring_flash_causal", dict(causal=True, use_flash=True)),
    ("zigzag_flash", dict(causal=True, layout="zigzag", use_flash=True)),
)


def _host(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(
        t, torch.Tensor) else t).copy()


def _rows(x, mesh):
    """This process's rows of a global (S, …) array (all of them in one
    process)."""
    n = x.shape[0] // mesh.process_count
    return x[mesh.process_index * n:(mesh.process_index + 1) * n]


def _barrier(mesh):
    from tpu_distalg_torch.parallel.collectives import row_counts

    row_counts(0, mesh)


# ------------------------------------------------------------- worker


def _stream(mesh, tmp: str, tag: str) -> dict:
    """Streamed SSGD (memmap and host memory, straight and segmented),
    virtual SSGD, minibatch k-means and streamed ALS on every backend."""
    from tpu_distalg_torch.data import builders
    from tpu_distalg_torch.models import als, kmeans, ssgd, ssgd_stream
    from tpu_distalg_torch.models import ssgd_virtual
    from tpu_distalg_torch.utils import datasets

    X, y, Xt, yt = datasets.breast_cancer_split()
    cfg = ssgd.SSGDConfig(n_iterations=STEPS, **FUSED)
    X2h, meta = ssgd_stream.pack_host(X, y, mesh, cfg)
    path = os.path.join(tmp, "packed.bin")
    if mesh.process_index == 0 and not os.path.exists(path):
        X2h.tofile(path)
    _barrier(mesh)
    mm = np.memmap(path, dtype=X2h.dtype, mode="r", shape=X2h.shape)
    out = {}
    for name, store in (("ssgd_stream_mm", mm), ("ssgd_stream_host", X2h)):
        r = ssgd_stream.train(store, meta, mesh, cfg, Xt, yt)
        out[name] = {"w": _host(r.w), "accs": _host(r.accs)}
    r = ssgd_stream.train(mm, meta, mesh, cfg, Xt, yt,
                          checkpoint_dir=os.path.join(tmp, f"{tag}_stream"),
                          checkpoint_every=5)
    out["ssgd_stream_seg"] = {"w": _host(r.w), "accs": _host(r.accs)}
    r = ssgd_virtual.train(mesh, ssgd.SSGDConfig(
        n_iterations=STEPS, sampler="virtual", gather_block_rows=64,
        mini_batch_fraction=0.25, eval_every=4),
        ssgd_virtual.VirtualData(n_rows=20_000, n_features=15),
        n_test=256)
    out["ssgd_virtual"] = {"w": _host(r.w), "accs": _host(r.accs)}
    for be in BACKENDS:
        pts = os.path.join(tmp, "pts") if be == "streamed" else None
        rk = os.path.join(tmp, "rk") if be == "streamed" else None
        if pts is not None and mesh.process_index != 0:
            _barrier(mesh)                  # process 0 builds first
        ds, _ = builders.gaussian_points_dataset(
            mesh, 4096, dim=4, k=3, seed=7, block_rows=64, backend=be,
            path=pts)
        ds_r, _ = builders.rank_k_rows_dataset(
            mesh, 96, 40, 4, seed=2, block_rows=8, backend=be, path=rk)
        if pts is not None and mesh.process_index == 0:
            _barrier(mesh)
        r = kmeans.fit_minibatch(ds, kmeans.KMeansConfig(k=3, seed=1),
                                 n_steps=10, mini_batch_blocks=2)
        out[f"kmeans_{be}"] = {"centers": _host(r.centers)}
        a = als.fit_streamed(ds_r, als.ALSConfig(lam=0.01, k=4,
                                                 n_iterations=3))
        out[f"als_{be}"] = {"U": _host(a.U), "V": _host(a.V),
                            "rmse": _host(a.rmse_history)}
    return out


def _pagerank(mesh, tmp: str, tag: str) -> dict:
    """Streamed PageRank on every backend and both combines, and in
    segments through a shared directory."""
    from tpu_distalg_torch import graphs

    path = os.path.join(tmp, "graph")
    if mesh.process_index == 0:
        graphs.build_powerlaw_block_cache(path, n_shards=4, **PL)
    _barrier(mesh)
    out = {}
    for be in BACKENDS:
        gd = graphs.open_graph_dataset(path, mesh, backend=be)
        for combine in ("sparse", "dense"):
            r = graphs.run_streamed_pagerank(gd, graphs.StreamedPageRankConfig(
                n_iterations=5, combine=combine))
            out[f"pagerank_{be}_{combine}"] = {"ranks": _host(r.ranks)}
    gd = graphs.open_graph_dataset(path, mesh)
    r = graphs.run_streamed_pagerank(
        gd, graphs.StreamedPageRankConfig(n_iterations=5),
        checkpoint_dir=os.path.join(tmp, f"{tag}_pr"), checkpoint_every=2)
    out["pagerank_seg"] = {"ranks": _host(r.ranks)}
    return out


def _pagerank_handoff(mesh, one, tmp: str, rank: int) -> dict:
    """3 sweeps by the pair, finished to 5 by one process."""
    from tpu_distalg_torch import graphs

    path = os.path.join(tmp, "graph")
    d = os.path.join(tmp, "pr_by_pair")
    graphs.run_streamed_pagerank(
        graphs.open_graph_dataset(path, mesh),
        graphs.StreamedPageRankConfig(n_iterations=3), checkpoint_dir=d,
        checkpoint_every=3)
    _barrier(mesh)
    if rank != 0:
        return {}
    r = graphs.run_streamed_pagerank(
        graphs.open_graph_dataset(path, one),
        graphs.StreamedPageRankConfig(n_iterations=5), checkpoint_dir=d,
        checkpoint_every=3)
    return {"pagerank_pair_to_one": {"ranks": _host(r.ranks)}}


def _attention_inputs(n_shards: int, zigzag: bool, seq: int = SEQ):
    from tpu_distalg_torch.parallel import ring

    rng = np.random.default_rng(31)
    q, k, v, g = (rng.normal(size=(seq, HEADS, DIM)).astype(np.float32)
                  for _ in range(4))
    if zigzag:
        order = ring.zigzag_order(n_shards, seq)
        q, k, v, g = (x[order] for x in (q, k, v, g))
    return q, k, v, g


def _rings(mesh, names=None, seq: int = SEQ) -> dict:
    """Each ring's output and the gradients of Σ out·g on this process's
    rows; Ulysses, the exchanges and the ring matmul."""
    from tpu_distalg_torch.parallel import ring

    out = {}
    for name, kw in RINGS:
        if names is not None and name not in names:
            continue
        if kw.get("use_flash"):
            kw = dict(kw, **FLASH)
        q, k, v, g = _attention_inputs(mesh.n_data,
                                       kw.get("layout") == "zigzag", seq)
        ts = [torch.tensor(_rows(a, mesh), requires_grad=True)
              for a in (q, k, v)]
        o = ring.ring_attention(*ts, mesh, **kw)
        (o * torch.from_numpy(_rows(g, mesh))).sum().backward()
        out[name] = {"out": _host(o), **{f"d{c}": _host(t.grad)
                                          for c, t in zip("qkv", ts)}}
    if names is not None:
        return out
    rng = np.random.default_rng(37)
    for flash in (False, True):
        q, k, v, g = (rng.normal(size=(256, 4, DIM)).astype(np.float32)
                      for _ in range(4))
        ts = [torch.tensor(_rows(a, mesh), requires_grad=True)
              for a in (q, k, v)]
        o = ring.ulysses_attention(*ts, mesh, causal=True, use_flash=flash)
        (o * torch.from_numpy(_rows(g, mesh))).sum().backward()
        out[f"ulysses{'_flash' if flash else ''}"] = {
            "out": _host(o), **{f"d{c}": _host(t.grad)
                                for c, t in zip("qkv", ts)}}
    x = rng.normal(size=(64, 4, 8)).astype(np.float32)
    heads = ring.alltoall_seq_to_head(torch.from_numpy(_rows(x, mesh)),
                                      mesh)
    out["alltoall"] = {"heads": _host(heads), "back": _host(
        ring.alltoall_head_to_seq(heads, mesh))}
    A, B = (rng.normal(size=(64, 16)).astype(np.float32) for _ in range(2))
    out["allgather_matmul"] = {"out": _host(ring.ring_allgather_matmul(
        torch.from_numpy(_rows(A, mesh)), torch.from_numpy(_rows(B, mesh)),
        mesh))}
    return out


def _worker(rank: int, world: int, init: str, outdir: str, procs: int,
            mode: str) -> None:
    from tpu_distalg_torch.parallel import Mesh, get_mesh
    from tpu_distalg_torch.parallel import mesh as pmesh

    share_host_threads(procs)
    pmesh.emulate_devices(2)
    pmesh.multihost_initialize(init, world, rank, device="cpu", timeout=120)
    try:
        mesh = get_mesh(device="cpu")          # 2 shards a process
        one = Mesh(n_data=mesh.n_data, device=torch.device("cpu"))
        flat = {}

        def add(prefix, results):
            flat.update({f"{prefix}/{n}/{k}": v for n, d in results.items()
                         for k, v in d.items()})

        if mode == "three":
            zig = ("zigzag", "zigzag_flash")
            add("multi", _rings(mesh, zig, seq=1536))
            if rank == 0:
                add("single", _rings(one, zig, seq=1536))
        else:
            add("multi", _stream(mesh, outdir, "pair"))
            add("multi", _pagerank(mesh, outdir, "pair"))
            add("single", _pagerank_handoff(mesh, one, outdir, rank))
            add("multi", _rings(mesh))
            if rank == 0:
                add("single", _stream(one, outdir, "one"))
                add("single", _pagerank(one, outdir, "one"))
                add("single", _rings(one))
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **flat)
    finally:
        pmesh.shutdown()


# -------------------------------------------------------------- parent


def _threads_share(world: int) -> int:
    return world * int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)


def _spawn(cmd_for_rank, world: int, timeout=SPAWN_TIMEOUT_S):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(cmd_for_rank(r), cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def _group(tmp, world: int, mode: str) -> list[dict]:
    init = f"file://{tmp / 'rendezvous'}"
    rcs, outs = _spawn(lambda r: [
        sys.executable, os.path.abspath(__file__), "worker", str(r),
        str(world), init, str(tmp), str(_threads_share(world)), mode],
        world)
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-4000:]
    loaded = []
    for r in range(world):
        with np.load(tmp / f"rank{r}.npz") as z:
            loaded.append({k: z[k] for k in z.files})
    return loaded


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The pair's results: ``(rank0, rank1)`` dicts of name/key →
    array, rank 0's with the one-process results under ``single``."""
    return _group(tmp_path_factory.mktemp("multiproc_stream"), 2, "main")


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    return _group(tmp_path_factory.mktemp("multiproc_stream3"), 3, "three")


def _keys(run: dict, prefix: str, name: str) -> dict:
    p = f"{prefix}/{name}/"
    return {k[len(p):]: v for k, v in run.items() if k.startswith(p)}


RING_NAMES = [n for n, _ in RINGS] + ["ulysses", "ulysses_flash",
                                      "allgather_matmul"]
#: results each process holds only its rows of: the streamed U, every
#: attention output and gradient, the exchanges and the ring product
ROW_SHARDED = ({(f"als_{be}", "U") for be in BACKENDS}
               | {(n, k) for n in RING_NAMES + ["alltoall"]
                  for k in ("out", "dq", "dk", "dv", "heads", "back")})
NAMES = (["ssgd_stream_mm", "ssgd_stream_host", "ssgd_stream_seg",
          "ssgd_virtual"]
         + [f"{w}_{be}" for w in ("kmeans", "als") for be in BACKENDS]
         + [f"pagerank_{be}_{c}" for be in BACKENDS
            for c in ("sparse", "dense")] + ["pagerank_seg"]
         + RING_NAMES + ["alltoall"])


def _assert_equal_one_process(runs, name, single_name=None):
    single = _keys(runs[0], "single", single_name or name)
    parts = [_keys(r, "multi", name) for r in runs]
    assert single and all(set(single) == set(p) for p in parts)
    for key, want in single.items():
        if (name, key) in ROW_SHARDED:
            got = np.concatenate([p[key] for p in parts])
        else:
            for p in parts[1:]:
                assert p[key].tobytes() == parts[0][key].tobytes(), key
            got = parts[0][key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), (name, key)


@pytest.mark.parametrize("name", NAMES)
def test_two_processes_equal_one_bitwise(runs, name):
    """2 processes × 2 shards = 1 process × 4 shards, bit for bit: the
    streamed and virtual trainers, minibatch k-means and streamed ALS on
    every backend, streamed PageRank on every backend and combine, and
    every ring (outputs and gradients); replicated results equal on both
    ranks, row-sharded ones each rank's own rows."""
    _assert_equal_one_process(runs, name)


@pytest.mark.parametrize("work", ["kmeans", "als", "pagerank_sparse",
                                  "pagerank_dense"])
def test_backends_equal_each_other_across_processes(runs, work):
    """resident = virtual = streamed bitwise on each rank."""
    for r in runs:
        got = [_keys(r, "multi", f"{work.split('_')[0]}_{be}"
                     + (f"_{work.split('_')[1]}" if "_" in work else ""))
               for be in BACKENDS]
        for other in got[1:]:
            for key in got[0]:
                assert other[key].tobytes() == got[0][key].tobytes(), key


def test_streamed_ssgd_memmap_host_and_segments_agree(runs):
    for r in runs:
        a = _keys(r, "multi", "ssgd_stream_mm")
        for name in ("ssgd_stream_host", "ssgd_stream_seg"):
            b = _keys(r, "multi", name)
            for key in a:
                assert a[key].tobytes() == b[key].tobytes(), (name, key)


def test_pagerank_checkpoint_from_the_pair_resumes_in_one_process(runs):
    """3 sweeps by the pair, 2 more by one process: one process's run
    of 5 sweeps, bit for bit."""
    got = _keys(runs[0], "single", "pagerank_pair_to_one")
    straight = _keys(runs[0], "single", "pagerank_seg")
    assert got["ranks"].tobytes() == straight["ranks"].tobytes()


@pytest.mark.parametrize("name", ["zigzag", "zigzag_flash"])
def test_three_processes_zigzag_equals_one(three, name):
    """3 processes × 2 shards = one process × 6: the zigzag ring's
    outputs and gradients on both paths, where the fold crosses two
    process boundaries."""
    _assert_equal_one_process(three, name)


# ---------------------------------------------------------- against JAX


def _jax_mesh(data):
    import jax

    from tpu_distalg.parallel import get_mesh as jget_mesh

    return jget_mesh(data=data, devices=jax.devices()[:data])


def test_streamed_ssgd_across_processes_matches_jax(runs):
    """``tests/test_torch_ssgd_stream.py``'s standard: w within 1e-4 of
    the largest |w|, the accuracies equal."""
    import dataclasses

    from tpu_distalg.models import ssgd as jssgd
    from tpu_distalg.models import ssgd_stream as jstream
    from tpu_distalg.utils import datasets as jdatasets

    X, y, Xt, yt = jdatasets.breast_cancer_split()
    from tpu_distalg_torch.models import ssgd

    jcfg = jssgd.SSGDConfig(**dataclasses.asdict(
        ssgd.SSGDConfig(n_iterations=STEPS, **FUSED)))
    mesh4 = _jax_mesh(4)
    jX2h, jmeta = jstream.pack_host(X, y, mesh4, jcfg)
    want = jstream.train(np.asarray(jX2h), jmeta, mesh4, jcfg, Xt, yt)
    got = _keys(runs[0], "multi", "ssgd_stream_mm")
    w = np.asarray(want.w)
    assert np.abs(got["w"] - w).max() <= 1e-4 * np.abs(w).max()
    np.testing.assert_array_equal(got["accs"], np.asarray(want.accs))


def test_streamed_pagerank_across_processes_matches_jax(runs, tmp_path):
    """Ranks within rtol 1e-5 / atol 1e-8 of the JAX package's engine on
    the same cache geometry."""
    from tpu_distalg import graphs as jgraphs

    path = str(tmp_path / "graph")
    jgraphs.build_powerlaw_block_cache(path, n_shards=4, **PL)
    want = np.asarray(jgraphs.run_streamed_pagerank(
        jgraphs.open_graph_dataset(path, _jax_mesh(4)),
        jgraphs.StreamedPageRankConfig(n_iterations=5)).ranks)
    for combine in ("sparse", "dense"):
        got = _keys(runs[0], "multi", f"pagerank_streamed_{combine}")
        np.testing.assert_allclose(got["ranks"], want, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("name", ["ring_causal", "zigzag", "ring_flash"])
def test_rings_across_processes_match_jax(runs, name):
    """Outputs within 1e-5 of the largest entry of JAX's XLA ring on a
    4-device mesh (the zigzag layout's rows as they are laid out)."""
    from jax.sharding import PartitionSpec as P

    from tpu_distalg.parallel import data_parallel, parallelize
    from tpu_distalg.parallel import ring as jring

    import functools

    import jax

    kw = dict(RINGS)[name]
    q, k, v, _ = _attention_inputs(4, kw.get("layout") == "zigzag")
    mesh4 = _jax_mesh(4)
    spec = P("data", None, None)
    fn = data_parallel(functools.partial(jring.ring_attention, **{
        key: val for key, val in kw.items() if key != "use_flash"}),
        mesh4, in_specs=(spec,) * 3, out_specs=spec)
    want = np.asarray(jax.jit(fn)(*(parallelize(x, mesh4).data
                                    for x in (q, k, v))))
    got = np.concatenate([_keys(r, "multi", name)["out"] for r in runs])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ------------------------------------------------------------- the CLI


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("argv,starts", [
    (["kmeans", "--data-backend", "streamed", "--stream-cache", "{tmp}/pts",
      "--scale-points", "8192", "--k", "3", "--dim", "4",
      "--minibatch-steps", "8", "--block-rows", "64"],
     ("Final centers", "minibatch steps")),
    (["als", "--data-backend", "streamed", "--stream-cache", "{tmp}/r",
      "--m", "96", "--n", "40", "--k", "4", "--n-iterations", "2",
      "--block-rows", "8"], ("iterations:",)),
    (["pagerank", "--data-backend", "streamed", "--n-vertices", "512",
      "--stream-cache", "{tmp}/g", "--n-iterations", "4"],
     (" has rank: ",)),
], ids=["kmeans", "als", "pagerank"])
def test_cli_streamed_backend_under_multihost(tmp_path, argv, starts):
    """``--data-backend streamed`` on the pair (one cache, written by
    process 0 first) prints one process's result lines on both ranks."""
    def argv_in(d):
        os.makedirs(d, exist_ok=True)
        return [a.replace("{tmp}", str(d)) for a in argv]

    coord = f"127.0.0.1:{_free_port()}"
    rcs, outs = _spawn(lambda r: [
        sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
        "--emulate", "2", "--multihost", "--coordinator-address", coord,
        "--num-processes", "2", "--process-id", str(r),
        *argv_in(tmp_path / "pair")], 2)
    (rc,), (one,) = _spawn(lambda r: [
        sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
        "--emulate", "4", *argv_in(tmp_path / "one")], 1)
    assert rc == 0, one[-4000:]

    def result(out):
        return [ln for ln in out.splitlines()
                if any(w in ln for w in starts)]

    want = result(one)
    assert want, one[-4000:]
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-4000:]
        assert result(out) == want, out[-4000:]


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "worker":
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
            int(sys.argv[6]), sys.argv[7])
