"""The port's binding of the C++ graph ingest (``tpu_distalg_torch/native``)
against its own numpy forms and the JAX package's binding
(``tpu_distalg/native``), on the CPU.

Standard: every output is integer (or float32 bits moved as int32), so
each function equals its numpy form and the JAX package's output exactly.
The fallback is visible: ``available()`` and the per-function path
counts. Deliberate difference: ``parse_edges_text`` raises past its
capacity on both paths (the JAX package's numpy fallback ignores it).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from tpu_distalg import native as jnative
from tpu_distalg_torch import native
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))


@pytest.fixture
def fallback():
    """The binding as it is where the library cannot load."""
    native.reset_calls()
    with native.numpy_forms():
        yield
    native.reset_calls()


def _edges(n, e, seed, hi=None):
    rng = np.random.default_rng(seed)
    hi = n if hi is None else hi
    return np.stack([rng.integers(0, hi, e), rng.integers(0, hi, e)],
                    1).astype(np.int64)


def _edge_file(tmp_path, edges, header="# an edge list\n"):
    path = tmp_path / "edges.txt"
    body = "".join(f"{s}\t{d}\n" if i % 3 else f"{s} {d}  # tail\n"
                   for i, (s, d) in enumerate(edges.tolist()))
    path.write_text(header + body + "\n")
    return str(path)


def _cases(tmp_path):
    """Each function's seeded call, as ``name -> (port fn, numpy form,
    jax fn, args)``; ids fit int32 where the layout needs it."""
    rng = np.random.default_rng(3)
    edges = _edges(300, 5000, 1)
    srt = np.sort(edges[:, 0])
    src = rng.integers(0, 1 << 20, 4097)
    dst = rng.integers(0, 1 << 20, 4097)
    w = rng.random(4097).astype(np.float32)
    path = _edge_file(tmp_path, edges[:200])
    return {
        "pack_edge_rows": (native.pack_edge_rows,
                           native.pack_edge_rows_numpy,
                           jnative.pack_edge_rows, (src, dst, w)),
        "dedupe_edges_pair": (native.dedupe_edges_pair,
                              native.dedupe_edges_pair_numpy,
                              jnative.dedupe_edges_pair, (edges,)),
        "dedupe_edges": (native.dedupe_edges,
                         lambda e: np.stack(
                             native.dedupe_edges_pair_numpy(e), 1),
                         jnative.dedupe_edges, (edges,)),
        "out_degree": (native.out_degree, native.out_degree_numpy,
                       jnative.out_degree, (edges[:, 0], 300)),
        "csr_offsets": (native.csr_offsets, native.csr_offsets_numpy,
                        jnative.csr_offsets, (srt, 300)),
        "counting_sort_perm": (native.counting_sort_perm,
                               native.counting_sort_perm_numpy,
                               jnative.counting_sort_perm,
                               (edges[:, 1], 300)),
        "parse_edges_text": (native.parse_edges_text,
                             native.parse_edges_text_numpy,
                             jnative.parse_edges_text, (path, 4096)),
    }


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", native.FUNCTIONS)
def test_each_function_equals_numpy_form_and_jax(name, tmp_path):
    assert native.available(), native.load_error()
    fn, numpy_form, jax_fn, args = _cases(tmp_path)[name]
    before = native.calls[name]["native"]
    got = fn(*args)
    assert native.calls[name]["native"] == before + 1
    _equal(got, numpy_form(*args))
    _equal(got, jax_fn(*args))


@pytest.mark.parametrize("name", native.FUNCTIONS)
def test_fallback_gives_the_same_bytes_and_is_counted(name, tmp_path,
                                                      fallback):
    fn, numpy_form, jax_fn, args = _cases(tmp_path)[name]
    assert not native.available()
    assert native.load_error() == "numpy_forms() in effect"
    got = fn(*args)
    assert native.calls[name] == {"native": 0, "numpy": 1}
    _equal(got, jax_fn(*args))


def test_dedupe_ids_past_32_bits():
    """Ids >= 2^32 take the C++ index sort (not the packed 64-bit keys)."""
    edges = _edges(0, 3000, 9, hi=1 << 40)
    edges[::7] = edges[1::7][:len(edges[::7])]       # duplicates
    edges[5, 0] = (1 << 33) + 5
    got = native.dedupe_edges_pair(edges)
    _equal(got, native.dedupe_edges_pair_numpy(edges))
    _equal(got, jnative.dedupe_edges_pair(edges))
    assert got[0].max() >= 1 << 32


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_out_of_range_ids_are_rejected(path, request):
    if path == "numpy":
        request.getfixturevalue("fallback")
    with pytest.raises(ValueError, match="out of range"):
        native.out_degree(np.array([0, 300]), 300)
    with pytest.raises(ValueError, match="out of range"):
        native.out_degree(np.array([-1, 3]), 300)
    with pytest.raises(ValueError, match="out of range"):
        native.counting_sort_perm(np.array([0, 300]), 300)
    with pytest.raises(ValueError, match="out of range"):
        native.counting_sort_perm(np.array([-2, 0]), 300)
    with pytest.raises(ValueError, match="out of range"):
        native.csr_offsets(np.array([0, 1, 300]), 300)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_capacity_and_missing_file(path, tmp_path, request):
    edges = _edges(50, 40, 2)
    f = _edge_file(tmp_path, edges)
    if path == "numpy":
        request.getfixturevalue("fallback")
    _equal(native.parse_edges_text(f, 40), edges)
    with pytest.raises(ValueError, match="exceeds capacity 39"):
        native.parse_edges_text(f, 39)
    with pytest.raises(FileNotFoundError):
        native.parse_edges_text(str(tmp_path / "absent.txt"), 40)
    if path == "native":
        # the JAX package's native path agrees (its fallback would not)
        _jax_native_loaded()
        with pytest.raises(ValueError, match="exceeds capacity 39"):
            jnative.parse_edges_text(f, 39)


def _jax_native_loaded() -> None:
    """Make sure this process holds the JAX package's library. Several
    test processes that load it first at the same moment each run its
    build (``native/Makefile``, one shared temporary name), and a
    process that loses that race keeps the numpy forms for its life
    (``tpu_distalg/native/__init__.py:load``): by the time it gets here
    another process's library is in place, so under a lock on
    ``build/`` the loser forgets its failed attempt and loads that
    library."""
    import fcntl

    lock_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build")
    os.makedirs(lock_dir, exist_ok=True)
    with open(os.path.join(lock_dir, "jax_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not jnative.available():
                jnative._load_attempted = False
                jnative.load()
            assert jnative.available(), \
                "the JAX package's native library did not load"
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def test_library_is_built_beside_the_package():
    """The port compiles native/graph_ingest.cpp itself into build/native
    (never the JAX package's Makefile target), named by a hash of the
    source and the flags."""
    assert native.available(), native.load_error()
    path = native.lib_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(os.path.dirname(path))) == \
        "build"
    assert os.path.exists(path)
    assert os.path.realpath(native.load()._name) == os.path.realpath(path)
    assert native.SOURCE.endswith(os.path.join("native",
                                               "graph_ingest.cpp"))


def test_numpy_forms_block_restores_the_library():
    assert native.available()
    with native.numpy_forms():
        assert not native.available()
    assert native.available() and native.load_error() is None


def test_empty_inputs():
    e = np.zeros((0, 2), np.int64)
    _equal(native.dedupe_edges_pair(e), native.dedupe_edges_pair_numpy(e))
    _equal(native.pack_edge_rows(e[:, 0], e[:, 1],
                                 np.zeros(0, np.float32)),
           np.zeros((0, 3), np.int32))
    _equal(native.out_degree(e[:, 0], 4), np.zeros(4, np.int32))
    _equal(native.csr_offsets(e[:, 0], 4), np.zeros(5, np.int64))
    _equal(native.counting_sort_perm(e[:, 0], 4), np.zeros(0, np.int64))
