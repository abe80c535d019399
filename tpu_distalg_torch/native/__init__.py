"""ctypes binding of the C++ graph ingest (``native/graph_ingest.cpp``).

Port of ``tpu_distalg/native/__init__.py``. The source is the repo's
``native/graph_ingest.cpp``, read as it is: the port compiles it with
``g++`` at first use (never at import) into ``build/native/`` beside the
package, named by a hash of the source and the flags, written under a
temporary name and renamed into place (several test workers may build
at once). It never runs ``native/Makefile``, whose target lies inside
the JAX package, and never loads that package's library.

Every function has a numpy form (``*_numpy``) that gives the same bytes;
the public function runs the library when it is loaded and the numpy
form otherwise. The JAX package falls back without a word; here the
fallback is kept but shows: :func:`available` says whether the library
loaded (:func:`load_error` why not), and :data:`calls` counts, per
function, how many calls took each path (``chip_smoke.py`` asserts the
native path ran on the card's machine). :func:`numpy_forms` takes the
numpy forms for a block, to time or test both paths in one process.

One deliberate difference from the JAX package: ``parse_edges_text``
raises past ``capacity`` on both paths. JAX's native path does; its
numpy fallback ignores the capacity.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "graph_ingest.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

FUNCTIONS = ("pack_edge_rows", "dedupe_edges_pair", "dedupe_edges",
             "out_degree", "csr_offsets", "counting_sort_perm",
             "parse_edges_text")
#: calls of each function by the path they took, ``"native"`` or
#: ``"numpy"`` (:func:`reset_calls` zeroes them)
calls = {name: {"native": 0, "numpy": 0} for name in FUNCTIONS}

_LOCK = threading.Lock()
_state: dict = {"lib": None, "tried": False, "error": None}


def reset_calls() -> None:
    for per in calls.values():
        per["native"] = per["numpy"] = 0


def _count(name: str, native: bool) -> None:
    calls[name]["native" if native else "numpy"] += 1


def lib_path() -> str:
    with open(SOURCE, "rb") as f:
        src = f.read()
    h = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libtda_ingest-{h[:16]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (rc {proc.returncode}) building "
                               f"{out}:\n{proc.stderr}")
        # tda: ignore[TDA030] -- a build cache, not durable state: the
        # library is a pure function of the source hash its name carries,
        # a lost or torn file is rebuilt at the next load, and no run's
        # state lives in it
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    for fn, args, res in (
            ("tda_dedupe_edges", [i64p, i64p, i64], i64),
            ("tda_out_degree", [i64p, i64, i32p, i64], None),
            ("tda_csr_offsets", [i64p, i64, i64p, i64], None),
            ("tda_parse_edges_text", [ctypes.c_char_p, i64p, i64p, i64],
             i64),
            ("tda_counting_sort_perm", [i64p, i64, i64, i64p],
             ctypes.c_int32),
            ("tda_pack_edge_rows", [i64p, i64p, f32p, i64, i32p], None)):
        f = getattr(lib, fn)
        f.argtypes = args
        f.restype = res
    return lib


def load() -> ctypes.CDLL | None:
    """The loaded library, built at first use; ``None`` when it cannot
    be built or loaded (the reason: :func:`load_error`), and the numpy
    forms run instead."""
    with _LOCK:
        if not _state["tried"]:
            _state["tried"] = True
            try:
                path = lib_path()
                if not os.path.exists(path):
                    _build(path)
                _state["lib"] = _declare(ctypes.CDLL(path))
            except (OSError, RuntimeError, subprocess.SubprocessError,
                    AttributeError) as e:
                _state["error"] = f"{type(e).__name__}: {e}"
        return _state["lib"]


def available() -> bool:
    """Whether the C++ library is loaded (building it if need be)."""
    return load() is not None


def load_error() -> str | None:
    """Why the library did not load, or None."""
    load()
    return _state["error"]


@contextlib.contextmanager
def numpy_forms():
    """Within the block every function takes its numpy form, as where
    the library cannot load (to time or test the two paths side by
    side); the library is back after it."""
    load()
    with _LOCK:
        saved = dict(_state)
        _state.update(lib=None, tried=True, error="numpy_forms() in effect")
    try:
        yield
    finally:
        with _LOCK:
            _state.update(saved)


# ------------------------------------------------------------ numpy forms


def pack_edge_rows_numpy(src, dst, w) -> np.ndarray:
    out = np.empty((len(src), 3), dtype=np.int32)
    out[:, 0] = np.asarray(src, np.int64).astype(np.int32)
    out[:, 1] = np.asarray(dst, np.int64).astype(np.int32)
    out[:, 2] = np.ascontiguousarray(w, np.float32).view(np.int32)
    return out


def dedupe_edges_pair_numpy(edges):
    uniq = np.unique(np.asarray(edges, np.int64).reshape(-1, 2), axis=0)
    return (np.ascontiguousarray(uniq[:, 0]),
            np.ascontiguousarray(uniq[:, 1]))


def out_degree_numpy(src, n_vertices: int) -> np.ndarray:
    return np.bincount(np.asarray(src, np.int64),
                       minlength=n_vertices).astype(np.int32)


def csr_offsets_numpy(sorted_src, n_vertices: int) -> np.ndarray:
    out = np.zeros((n_vertices + 1,), dtype=np.int64)
    np.cumsum(np.bincount(np.asarray(sorted_src, np.int64),
                          minlength=n_vertices)[:n_vertices], out=out[1:])
    return out


def counting_sort_perm_numpy(keys, key_range: int) -> np.ndarray:
    return np.argsort(np.asarray(keys, np.int64), kind="stable")


def parse_edges_text_numpy(path: str, capacity: int) -> np.ndarray:
    edges = np.loadtxt(path, dtype=np.int64, comments="#",
                       ndmin=2).reshape(-1, 2)
    if len(edges) > capacity:
        raise ValueError(f"edge file exceeds capacity {capacity}")
    return edges


# ------------------------------------------------------------ the binding


def pack_edge_rows(src: np.ndarray, dst: np.ndarray,
                   w: np.ndarray) -> np.ndarray:
    """Interleave dst-sorted edge columns into packed ``(E, 3)`` int32
    cache rows ``[src, dst, bits(w)]``, the ``csr_edge_blocks_i32``
    layout (``graphs/ingest.py``). Ids must fit int32 (the layout's id
    width; callers check the range)."""
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    w = np.ascontiguousarray(w, dtype=np.float32)
    lib = load()
    _count("pack_edge_rows", lib is not None)
    if lib is None:
        return pack_edge_rows_numpy(src, dst, w)
    out = np.empty((len(src), 3), dtype=np.int32)
    if len(src):
        lib.tda_pack_edge_rows(src, dst, w, len(src), out)
    return out


def _dedupe(edges, name: str):
    edges = np.ascontiguousarray(edges, dtype=np.int64).reshape(-1, 2)
    lib = load()
    _count(name, lib is not None)
    if lib is None:
        return dedupe_edges_pair_numpy(edges)
    src = np.ascontiguousarray(edges[:, 0])
    dst = np.ascontiguousarray(edges[:, 1])
    m = lib.tda_dedupe_edges(src, dst, len(src)) if len(src) else 0
    return src[:m], dst[:m]


def dedupe_edges_pair(edges: np.ndarray):
    """Sorted, deduplicated (src, dst) int64 columns of an (E, 2) edge
    array: ``links.distinct()`` set semantics (reference
    ``pagerank.py:41``)."""
    return _dedupe(edges, "dedupe_edges_pair")


def dedupe_edges(edges: np.ndarray) -> np.ndarray:
    """(E', 2) stacked form of :func:`dedupe_edges_pair`."""
    src, dst = _dedupe(edges, "dedupe_edges")
    return np.stack([src, dst], axis=1)


def out_degree(src: np.ndarray, n_vertices: int) -> np.ndarray:
    """(n_vertices,) int32 count of each id in ``src``; an id outside
    ``[0, n_vertices)`` raises (the C++ histogram would write out of
    bounds)."""
    src = np.ascontiguousarray(src, dtype=np.int64)
    if len(src) and (int(src.min()) < 0 or int(src.max()) >= n_vertices):
        raise ValueError(
            f"src id out of range for n_vertices={n_vertices}: "
            f"[{int(src.min())}, {int(src.max())}]")
    lib = load()
    _count("out_degree", lib is not None)
    if lib is None:
        return out_degree_numpy(src, n_vertices)
    deg = np.zeros((n_vertices,), dtype=np.int32)
    lib.tda_out_degree(src, len(src), deg, n_vertices)
    return deg


def csr_offsets(sorted_src: np.ndarray, n_vertices: int) -> np.ndarray:
    """Row offsets (n_vertices + 1,) int64 of edges sorted by src, ids
    in ``[0, n_vertices)``."""
    sorted_src = np.ascontiguousarray(sorted_src, dtype=np.int64)
    if len(sorted_src) and (int(sorted_src[0]) < 0
                            or int(sorted_src[-1]) >= n_vertices):
        raise ValueError(f"csr_offsets: id out of range [0, {n_vertices})")
    lib = load()
    _count("csr_offsets", lib is not None)
    if lib is None:
        return csr_offsets_numpy(sorted_src, n_vertices)
    out = np.zeros((n_vertices + 1,), dtype=np.int64)
    lib.tda_csr_offsets(sorted_src, len(sorted_src), out, n_vertices)
    return out


def counting_sort_perm(keys: np.ndarray, key_range: int) -> np.ndarray:
    """Stable argsort (int64) of integer keys in ``[0, key_range)``, the
    host prep behind PageRank's dst-sorted edge layout; a key out of
    range raises on both paths."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if len(keys) and (keys.min() < 0 or keys.max() >= key_range):
        raise ValueError(
            f"counting_sort_perm: key out of range [0, {key_range})")
    lib = load()
    _count("counting_sort_perm", lib is not None)
    if lib is None:
        return counting_sort_perm_numpy(keys, key_range)
    perm = np.empty((len(keys),), dtype=np.int64)
    if len(keys) and lib.tda_counting_sort_perm(keys, len(keys), key_range,
                                                perm):
        raise ValueError(
            f"counting_sort_perm: key out of range [0, {key_range})")
    return perm


def parse_edges_text(path: str, capacity: int) -> np.ndarray:
    """Parse a '#'-commented whitespace edge-list file into (E, 2)
    int64. More than ``capacity`` edges raise ValueError, a missing file
    FileNotFoundError, on both paths."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    lib = load()
    _count("parse_edges_text", lib is not None)
    if lib is None:
        return parse_edges_text_numpy(path, capacity)
    src = np.empty((capacity,), dtype=np.int64)
    dst = np.empty((capacity,), dtype=np.int64)
    n = lib.tda_parse_edges_text(os.fsencode(path), src, dst, capacity)
    if n == -1:
        raise FileNotFoundError(path)
    if n == -2:
        raise ValueError(f"edge file exceeds capacity {capacity}")
    return np.stack([src[:n], dst[:n]], axis=1)
