"""Datasets of the ported slices: the SSGD reference task, synthetic
classification data (also made on the device, row by row), the graphs
of PageRank and the closure, and k-means' points.

Port of the parts of ``tpu_distalg/utils/datasets.py`` that SSGD,
PageRank and k-means use; the numpy generators draw from the same
streams, so both packages make the same arrays from a seed, and
:func:`streamed_packed_cache` writes the JAX package's cache bytes.
:func:`gaussian_mixture_rows` is the exception: it keeps the JAX
generator's contract (a row's content depends on the seed and the row's
global id alone) on the port's own threefry counters, not its bits.
:func:`synthetic_two_class_rows` draws the JAX generator's own bits
(``jax.random.normal``/``logistic`` under the same keys); its floats
may sit a few ulp from JAX's (:func:`..utils.prng.normal`).
:func:`closure_dag_edges` and :func:`closure_host_count` are copies of
``bench.py``'s closure helpers (``bench.py:1108-1140``).
The SSGD reference trains
on breast-cancer with a fixed 70/30 split and a ones column appended
(the model has D+1 weights). The machine with the
card has no scikit-learn, so the data ships with the package
(``data/breast_cancer.csv``, copied from scikit-learn, BSD-3; see
``data/breast_cancer.NOTICE``) and the split is reproduced with numpy
alone: ``train_test_split(test_size=0.3, random_state=0,
shuffle=True)`` permutes the rows with ``RandomState(0)`` and takes
the first 171 as the test set and the next 398 as the training set.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from tpu_distalg_torch.utils import prng

BREAST_CANCER_CSV = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "breast_cancer.csv")


def load_breast_cancer() -> tuple[np.ndarray, np.ndarray]:
    """``(X (569, 30) float64, y (569,) int64)``, as scikit-learn's
    ``load_breast_cancer(return_X_y=True)``."""
    with open(BREAST_CANCER_CSV) as f:
        n, d = (int(v) for v in f.readline().split(",")[:2])
        raw = np.loadtxt(f, delimiter=",", dtype=np.float64)
    if raw.shape != (n, d + 1):
        raise ValueError(f"{BREAST_CANCER_CSV}: expected {n} rows of "
                         f"{d + 1} columns, got {raw.shape}")
    return raw[:, :d], raw[:, d].astype(np.int64)


def breast_cancer_split(test_size: float = 0.3, random_state: int = 0):
    """Breast-cancer 70/30 split with the bias column appended — the
    reference task. Returns ``(X_train1, y_train, X_test1, y_test)``,
    float32, equal to the JAX package's ``breast_cancer_split``."""
    X, y = load_breast_cancer()
    n = X.shape[0]
    n_test = math.ceil(test_size * n)
    # tda: ignore[TDA001] -- seeded by the caller: RandomState(seed) is
    # the generator sklearn's train_test_split draws this permutation
    # from (the JAX package calls sklearn, which the card's machine
    # lacks); default_rng would draw another split
    perm = np.random.RandomState(random_state).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    return (add_bias_column(X[train]), y[train].astype(np.float32),
            add_bias_column(X[test]), y[test].astype(np.float32))


def add_bias_column(X: np.ndarray) -> np.ndarray:
    return np.concatenate(
        [X, np.ones((X.shape[0], 1))], axis=1).astype(np.float32)


def synthetic_two_class(n_rows: int, n_features: int = 30, seed: int = 0,
                        separation: float = 2.0):
    """Linearly-separable-ish two-class Gaussian data for LR benchmarks
    (numpy only: the same arrays as the JAX package's)."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(n_features,))
    X = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    logits = X @ w_true * separation / np.sqrt(n_features)
    y = (logits + rng.logistic(size=n_rows) > 0).astype(np.float32)
    return X, y


def erdos_renyi_edges(
    n_vertices: int, avg_degree: float = 8.0, seed: int = 0
) -> np.ndarray:
    """Uniform-random directed edge list (src, dst), shape (E, 2), no
    self-loops — the 1M-node PageRank benchmark graph (BASELINE.json)."""
    rng = np.random.default_rng(seed)
    n_edges = int(n_vertices * avg_degree)
    src = rng.integers(0, n_vertices, size=n_edges, dtype=np.int64)
    dst = rng.integers(0, n_vertices - 1, size=n_edges, dtype=np.int64)
    dst = np.where(dst >= src, dst + 1, dst)  # avoid self-loops
    return np.stack([src, dst], axis=1)


def synthetic_two_class_rows(n_features: int, seed: int = 0,
                             separation: float = 2.0):
    """Per-row generator of the two-class task, the device-side sibling
    of :func:`synthetic_two_class` (``datasets.py:56-86`` of the JAX
    package). Returns ``make_rows(row_ids) -> (X, y)``: for an int64
    tensor of global row ids, on the ids' device, the (n, n_features)
    float32 X and (n,) float32 labels (no bias column). With ``key =
    root_key(seed)``: ``w_true = normal(fold_in(key, 0), (nf,))``; row
    i's key ``k = fold_in(fold_in(key, 1), i)``, its X ``normal(k,
    (nf,))``, its noise ``logistic(fold_in(k, 7), ())``, and ``y =
    (X·w_true·(separation/√nf) + noise > 0)``. A row depends on the seed
    and its id alone."""
    root = prng.root_key(seed)
    k_w, k_rows = prng.fold_in(root, 0), prng.fold_in(root, 1)
    scale = np.float32(separation / np.float32(np.sqrt(np.float32(
        n_features))))

    def make_rows(row_ids: torch.Tensor):
        dev = row_ids.device
        w_true = prng.normal(k_w.to(dev), (n_features,))
        keys = prng.fold_in(k_rows.to(dev), row_ids.to(torch.int64))
        X = prng.normal(keys, (n_features,))
        noise = prng.logistic(prng.fold_in(keys, 7), ())
        logits = (X @ w_true) * torch.tensor(scale, device=dev)
        return X, (logits + noise > 0).to(torch.float32)

    return make_rows


def chain_forest_edges(n_vertices: int, chain_len: int = 8) -> np.ndarray:
    """Disjoint directed chains — a bounded-closure graph (the closure
    of an ER graph in the supercritical regime is Θ(V²) pairs; chains
    give closure = (V/L)·C(L,2), linear in V)."""
    chain_len = max(2, min(chain_len, n_vertices))
    if n_vertices < 2:
        return np.zeros((0, 2), dtype=np.int64)
    starts = np.arange(0, n_vertices - chain_len + 1, chain_len)
    src = np.concatenate([s + np.arange(chain_len - 1) for s in starts])
    return np.stack([src, src + 1], axis=1).astype(np.int64)


def closure_dag_edges(V: int, deg: int, seed: int = 0) -> np.ndarray:
    """The closure bench's forward random DAG (every vertex but the last
    gets ``deg`` random forward edges), deduplicated."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(V - 1), deg)
    span = V - 1 - src
    dst = src + 1 + (rng.random(len(src)) * span).astype(np.int64)
    return np.unique(np.stack([src, dst], 1), axis=0)


def closure_host_count(V: int, edges) -> int:
    """Exact closure size of a forward DAG by a reverse-topological
    bitset DP on the host, O(E·V/64) word operations."""
    adj: list[list[int]] = [[] for _ in range(V)]
    for s, dd in edges:
        adj[int(s)].append(int(dd))
    words = (V + 63) // 64
    reach = np.zeros((V, words), np.uint64)
    total = 0
    for i in range(V - 1, -1, -1):
        for j in adj[i]:
            reach[i] |= reach[j]
            reach[i, j // 64] |= np.uint64(1 << (j % 64))
        total += int(np.bitwise_count(reach[i]).sum()) \
            if hasattr(np, "bitwise_count") else sum(
                bin(int(w)).count("1") for w in reach[i])
    return total


def toy_graph_edges() -> np.ndarray:
    """The reference's 4-edge toy graph (``pagerank.py:35-38``,
    ``transitive_closure.py:18``), 0-indexed."""
    return np.array([[0, 1], [0, 2], [1, 2], [2, 0]], dtype=np.int64)


def toy_kmeans_matrix() -> np.ndarray:
    """The reference's hard-coded 6x2 k-means input (``k-means.py:49-50``)."""
    return np.array(
        [[1, 2], [1, 4], [1, 0], [10, 2], [10, 4], [10, 0]], dtype=np.float32
    )


def gaussian_mixture(
    n_rows: int, k: int = 4, dim: int = 2, seed: int = 0, spread: float = 8.0
) -> np.ndarray:
    """Gaussian-mixture points for k-means (numpy only: the same array
    as the JAX package's)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, dim)) * spread
    assign = rng.integers(0, k, size=n_rows)
    return (centers[assign] + rng.normal(size=(n_rows, dim))).astype(np.float32)


#: rows :func:`gaussian_mixture_rows` draws at a time (bounds its int64
#: temporaries to about 0.5 GB at dim 16)
_ROWS_PER_DRAW = 1 << 20


def _counter_normal(key: torch.Tensor, rows: torch.Tensor,
                    n_cols: int) -> torch.Tensor:
    """(len(rows), n_cols) standard normals: entry (i, j) is the
    Box-Muller transform of the two threefry2x32 words of the counter
    ``(rows[i], j)`` under ``key``, each word's top 23 bits a uniform."""
    cols = torch.arange(n_cols, dtype=torch.int64, device=rows.device)
    w1, w2 = prng.threefry2x32(key[0], key[1], rows[:, None] & prng.MASK32,
                               cols[None, :])

    def unit(words):                             # [0, 1)
        return ((words >> 9) | 0x3F800000).to(torch.int32).view(
            torch.float32) - 1.0

    radius = torch.sqrt(-2.0 * torch.log(1.0 - unit(w1)))   # 1 − u in (0, 1]
    return radius * torch.cos((2.0 * np.pi) * unit(w2))


def gaussian_mixture_rows(k: int = 4, dim: int = 2, seed: int = 0,
                          spread: float = 8.0):
    """Per-row Gaussian-mixture generator for ``parallel.build_sharded``:
    the sibling of :func:`gaussian_mixture` that needs no host memory.
    Returns ``(make_rows, true_centers)``: ``make_rows(row_ids)`` gives
    the (n, dim) float32 points of an int64 tensor of global row ids
    (below 2³²), on the ids' device; ``true_centers(device="cpu")`` the
    (k, dim) mixture means, N(0, spread²), for recovery checks. A row is
    its component's mean (the component drawn uniformly from the row's
    counter) plus N(0, 1) noise, and depends on the seed and the row id
    alone, not on how the rows are sharded or batched. The values are
    the port's own: the JAX package draws the same distribution from
    other bits."""
    root = prng.root_key(seed)
    k_c, k_rows = prng.fold_in(root, 0), prng.fold_in(root, 1)

    def true_centers(device: str | torch.device = "cpu") -> torch.Tensor:
        ids = torch.arange(k, dtype=torch.int64, device=device)
        return _counter_normal(k_c.to(device), ids, dim) * spread

    def make_rows(row_ids: torch.Tensor) -> torch.Tensor:
        dev = row_ids.device
        centers, key = true_centers(dev), k_rows.to(dev)
        out = torch.empty((row_ids.shape[0], dim), dtype=torch.float32,
                          device=dev)
        for lo in range(0, row_ids.shape[0], _ROWS_PER_DRAW):
            ids = row_ids[lo:lo + _ROWS_PER_DRAW].to(torch.int64)
            # the component: counter (row, dim), one past the noise's
            word, _ = prng.threefry2x32(key[0], key[1], ids & prng.MASK32,
                                        torch.full_like(ids, dim))
            assign = (word * k) >> 32            # uniform in [0, k)
            out[lo:lo + _ROWS_PER_DRAW] = (
                centers[assign] + _counter_normal(key, ids, dim))
        return out

    return make_rows, true_centers


def streamed_packed_cache(path: str, n_rows: int, n_features: int, *,
                          n_shards: int, pack: int = 16,
                          gather_block_rows: int = 8192, seed: int = 0,
                          x_dtype="bfloat16", chunk_rows: int = 1 << 21,
                          n_test: int = 8192):
    """Create or reopen the disk-backed packed two-class dataset of the
    streamed trainer (``models/ssgd_stream``), the JAX package's
    ``utils/datasets.streamed_packed_cache`` (``:173-312``) byte for
    byte: ``<path>.bin`` in the ``pack_augmented`` layout,
    ``<path>.meta.json`` (``data/cache.py``'s header), ``<path>.test.npz``
    a held-out split from the same teacher (X, y, w_true). Rows are a
    noisy linear-teacher task: features ±(1 + m/128), m uniform in
    0..127, made as raw bfloat16 bit patterns in uint16, labels
    Bernoulli at the teacher's sigmoid. Returns ``(memmap X2 of uint16
    bfloat16 bits, meta, (X_test, y_test))``; a cache of the same
    geometry reopens read-only, a legacy flat-geometry one too."""
    from tpu_distalg_torch.data import cache as dcache
    from tpu_distalg_torch.ops import ssgd_kernels
    from tpu_distalg_torch.telemetry import events as tevents

    d = n_features + 1  # + bias, like the resident task
    d_t, y_col, v_col = ssgd_kernels.packed_dims(d, pack)
    mult = pack * gather_block_rows * n_shards
    if n_rows % mult:
        raise ValueError(
            f"n_rows={n_rows} must be a multiple of pack×block×shards="
            f"{mult} (no padding rows in a memmap dataset)")
    n2 = n_rows // pack
    pd = pack * d_t
    geom = dict(n_rows=n_rows, n_features=n_features, pack=pack,
                d_total=d_t, y_col=y_col, v_col=v_col, seed=seed,
                x_dtype=str(x_dtype), n_test=n_test)
    meta = dict(pack=pack, d_total=d_t, y_col=y_col, v_col=v_col,
                n_padded=n_rows)
    if ssgd_kernels.as_dtype(x_dtype).itemsize != 2:
        raise ValueError(
            f"streamed cache generates bf16 bit-packed rows; "
            f"x_dtype={x_dtype} is not 2-byte")
    rng = np.random.default_rng(seed)
    # the teacher: logit std about 2 on features of variance E[(1+u)²]
    wf = rng.standard_normal(d - 1).astype(np.float32)
    var_x = 1.0 + 2 * (63.5 / 128.0) + float(
        np.mean((np.arange(128) / 128.0) ** 2))
    wf *= 2.0 / np.sqrt(np.sum(wf ** 2) * var_x)
    w_true = np.concatenate([wf, [0.0]]).astype(np.float32)
    exp0 = np.uint16(127 << 7)   # the exponent field of [1, 2)
    one = np.uint16(0x3F80)      # bfloat16 1.0

    def _values(bits):
        """The float32 values ±(1 + m/128) of bfloat16 bit patterns:
        exactly the JAX package's ``(1 + m/128)·(1 − 2·sign)``, made by
        widening the bits (two passes over the rows instead of six)."""
        return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)

    def gen_bits(n, g):
        """(n, d) bfloat16 bit patterns and labels; column d-1 is the
        bias, exactly +1.0."""
        m = g.integers(0, 128, size=(n, d), dtype=np.uint16)
        sgn = g.integers(0, 2, size=(n, d), dtype=np.uint16)
        m[:, -1] = 0
        sgn[:, -1] = 0
        bits = exp0 | m | (sgn << np.uint16(15))
        p = 1.0 / (1.0 + np.exp(-(_values(bits[:, :-1]) @ wf)))
        y = g.random(n, dtype=np.float32) < p
        return bits, y

    def write_bin(mm):
        # ``rng`` continues from the teacher's draw, as in the JAX package
        chunk = chunk_rows - (chunk_rows % pack)
        out = np.zeros((chunk, d_t), np.uint16)
        for lo in range(0, n_rows, chunk):
            tevents.mark(f"streamed_cache:gen@{lo}/{n_rows}",
                         emit_event=False)
            n_c = min(chunk, n_rows - lo)
            bits, yc = gen_bits(n_c, rng)
            out[:n_c, :d] = bits
            out[:n_c, y_col] = np.where(yc, one, np.uint16(0))
            out[:n_c, v_col] = one
            mm[lo // pack:(lo + n_c) // pack] = out[:n_c].reshape(
                n_c // pack, pd)

    def write_test(tmp_path):
        bits_t, y_test = gen_bits(n_test, np.random.default_rng(seed + 1))
        X_test = _values(bits_t)
        # a file handle: np.savez on a path would append '.npz'
        # tda: ignore[TDA030] -- aux writer invoked INSIDE
        # cache.build_cache's cache:write seam (tmp→rename publish and
        # injection both happen there); single-file analysis cannot
        # see the callback edge
        with open(tmp_path, "wb") as f:
            np.savez(f, X=X_test, y=y_test.astype(np.float32),
                     w_true=w_true)

    header = dcache.make_header(layout="packed_augmented",
                                dtype=str(x_dtype), shape=(n2, pd),
                                geom=geom)
    X2, _ = dcache.open_or_build(
        path, header=header, write_bin=write_bin,
        aux=[("test.npz", write_test)], legacy_geom=geom)
    if X2 is None:  # a legacy cache (flat geometry meta.json)
        X2 = np.memmap(dcache.bin_path(path), dtype=np.uint16, mode="r",
                       shape=(n2, pd))
    t = np.load(path + ".test.npz")
    return X2, meta, (t["X"], t["y"])
