"""The packed-cache format: versioned on-disk datasets, atomic publish.

Port of ``tpu_distalg/data/cache.py`` (numpy and the standard library
only, there and here). A cache is ``<path>.bin`` (a flat row-major
memmap) and ``<path>.meta.json`` (the header), optionally with named
aux payloads (``<path>.<name>``: held-out splits, teacher weights).
The bytes and the header are the JAX package's, so a cache written by
either package opens in the other.

Header (``meta.json``), one JSON object::

    {"format": "tda-packed-cache", "version": 2,
     "layout": "<layout name>",        # what the rows mean
     "dtype": "<numpy or ml_dtypes name>",
     "shape": [n_rows, row_width],
     "geom": {...}}                    # layout-specific geometry

``geom`` must equal the expected geometry on reopen. Caches written
before the versioned header have their flat geometry dict as the whole
``meta.json``; :func:`open_cache` accepts those through
``legacy_geom``.

dtypes: the card's machine has no ``ml_dtypes``, so a ``"bfloat16"``
header opens as a ``np.uint16`` memmap of the same bits
(:func:`storage_dtype`), and reaches torch as
``torch.from_numpy(...).view(torch.bfloat16)`` (:func:`torch_dtype`).

Publish protocol: every artifact is written under a PID/uuid tmp name
and ``os.replace``d into place (two processes building one path both
publish and the last rename wins; the content is deterministic in the
header, so either winner has the same bytes); the order is aux files →
``.bin`` → ``meta.json`` LAST, so the header's presence means the rest
is complete; tmp orphans of crashed builds are swept, age-gated, on the
next build. A transient ``OSError`` (the ``cache:write`` fault seam's
included) retries the whole build in place, :data:`BUILD_RETRIES` times.
"""

from __future__ import annotations

import glob
import json
import os
import time
import uuid

import numpy as np

from tpu_distalg_torch import faults
from tpu_distalg_torch.telemetry import events as tevents

#: extra build attempts after a transient OSError, and the fixed pause
#: between them (a longer outage is the caller's to handle)
BUILD_RETRIES = 2
BUILD_BACKOFF_SECONDS = 0.05

FORMAT = "tda-packed-cache"
FORMAT_VERSION = 2
#: tmp files older than this are a crashed build's orphans, not a live
#: build's (a 32 GB generation takes about a quarter of an hour)
STALE_TMP_SECONDS = 6 * 3600.0

#: header dtype names numpy does not know, and the numpy type of the
#: same width their bits are stored in
_BIT_STORAGE = {"bfloat16": np.dtype(np.uint16)}


def bin_path(path: str) -> str:
    return path + ".bin"


def meta_path(path: str) -> str:
    return path + ".meta.json"


def aux_path(path: str, name: str) -> str:
    return f"{path}.{name}"


def make_header(*, layout: str, dtype, shape, geom: dict) -> dict:
    return {
        "format": FORMAT,
        "version": FORMAT_VERSION,
        "layout": str(layout),
        "dtype": dtype if isinstance(dtype, str) else str(np.dtype(dtype)),
        "shape": [int(x) for x in shape],
        "geom": dict(geom),
    }


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a header's ``dtype`` is stored as: numpy's own,
    or the unsigned integer of its width for ``bfloat16``."""
    if name in _BIT_STORAGE:
        return _BIT_STORAGE[name]
    return np.dtype(name)


def torch_dtype(name: str):
    """The torch dtype of a header's ``dtype`` name."""
    import torch

    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(name))).dtype


def exists(path: str) -> bool:
    """True iff the cache is complete (header published after the bin)."""
    return os.path.exists(meta_path(path)) and os.path.exists(bin_path(path))


def read_header(path: str) -> dict | None:
    if not os.path.exists(meta_path(path)):
        return None
    with open(meta_path(path)) as f:
        return json.load(f)


def open_cache(path: str, *, layout: str | None = None,
               expect_geom: dict | None = None,
               legacy_geom: dict | None = None):
    """Reopen a complete cache read-only: ``(memmap, header)``.

    Raises ``FileNotFoundError`` when the cache is absent or partial and
    ``ValueError`` on a wrong format marker, a version this reader does
    not speak, another layout, or geometry other than ``expect_geom``.
    A legacy flat-geometry ``meta.json`` equal to ``legacy_geom`` is
    accepted as ``(None, synthetic v1 header)``: its caller knows the
    dtype and shape and opens the memmap itself."""
    header = read_header(path)
    if header is None or not os.path.exists(bin_path(path)):
        raise FileNotFoundError(
            f"no complete packed cache at {path!r} (meta.json is "
            "published last — a .bin without it is a half-finished "
            "build)")
    if "format" not in header:
        if legacy_geom is None or header != legacy_geom:
            raise ValueError(
                f"cache at {path} has a legacy header {header} that "
                f"does not match the expected geometry "
                f"{legacy_geom}; delete it or use another path")
        return None, {"format": FORMAT, "version": 1,
                      "layout": layout or "", "dtype": None, "shape": None,
                      "geom": dict(legacy_geom)}
    if header.get("format") != FORMAT:
        raise ValueError(
            f"cache at {path} is not a {FORMAT} artifact "
            f"(format={header.get('format')!r})")
    if header.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"cache at {path} has format version "
            f"{header.get('version')!r}; this reader speaks "
            f"{FORMAT_VERSION} — regenerate the cache (or upgrade)")
    if layout is not None and header.get("layout") != layout:
        raise ValueError(
            f"cache at {path} holds layout {header.get('layout')!r}, "
            f"wanted {layout!r}")
    if expect_geom is not None and header.get("geom") != expect_geom:
        raise ValueError(
            f"cache at {path} was built with {header.get('geom')}, "
            f"wanted {expect_geom}; delete it or use another path")
    mm = np.memmap(bin_path(path), dtype=storage_dtype(header["dtype"]),
                   mode="r", shape=tuple(header["shape"]))
    return mm, header


def shard_rows(n_rows: int, n_shards: int, shard: int) -> tuple[int, int]:
    """The contiguous ``[lo, hi)`` row range shard ``shard`` owns (rows
    divide the shards exactly: a memmap dataset has no padding rows)."""
    if n_rows % n_shards:
        raise ValueError(
            f"{n_rows} cache rows do not divide {n_shards} shards")
    per = n_rows // n_shards
    return shard * per, (shard + 1) * per


def shard_view(mm: np.ndarray, n_shards: int, shard: int) -> np.ndarray:
    """Zero-copy view of one shard's contiguous row range."""
    lo, hi = shard_rows(mm.shape[0], n_shards, shard)
    return mm[lo:hi]


def sweep_stale_tmp(path: str) -> None:
    """Remove tmp orphans of crashed builds of THIS cache (globs anchored
    to its exact artifact names, so a sibling cache sharing the prefix
    is never touched), older than :data:`STALE_TMP_SECONDS`."""
    now = time.time()  # compared with file mtimes, wall-clock by nature
    for pat in (bin_path(path) + ".tmp.*", meta_path(path) + ".tmp.*",
                path + ".*.tmp.*"):
        for stale in sorted(glob.glob(pat)):
            try:
                if now - os.path.getmtime(stale) > STALE_TMP_SECONDS:
                    os.remove(stale)
            except OSError:
                pass  # a concurrent build may have just published it


def build_cache(path: str, *, header: dict, write_bin, aux=()):
    """Generate and atomically publish a cache; returns the read-only
    reopened ``(memmap, header)``.

    ``write_bin(memmap)`` fills the ``header['shape']`` memmap, opened
    ``w+`` in :func:`storage_dtype` of the header's dtype. ``aux`` is a
    sequence of ``(name, write_fn)``: ``write_fn(tmp_path)`` writes the
    payload, published before the bin as ``<path>.<name>``. The content
    must be deterministic in the header. The build runs in a
    ``data:cache_build`` span; each attempt passes the ``cache:write``
    fault seam, and a transient ``OSError`` retries the whole attempt
    (``cache.write_failures`` counts the failed ones)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    sweep_stale_tmp(path)
    dtype = storage_dtype(header["dtype"])
    shape = tuple(header["shape"])
    tag = f".tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    bin_tmp, meta_tmp = bin_path(path) + tag, meta_path(path) + tag
    aux_tmps = [(aux_path(path, name), aux_path(path, name) + tag, fn)
                for name, fn in aux]
    tmps = [bin_tmp, meta_tmp] + [t for _, t, _ in aux_tmps]

    def build_once():
        faults.inject("cache:write")
        mm = np.memmap(bin_tmp, dtype=dtype, mode="w+", shape=shape)
        write_bin(mm)
        mm.flush()
        del mm
        for final, tmp, fn in aux_tmps:
            fn(tmp)
            os.replace(tmp, final)
        os.replace(bin_tmp, bin_path(path))
        with open(meta_tmp, "w") as f:
            json.dump(header, f)
        os.replace(meta_tmp, meta_path(path))

    try:
        with tevents.span("data:cache_build", path=path,
                          layout=header.get("layout"),
                          bytes=int(np.prod(shape)) * dtype.itemsize):
            for attempt in range(BUILD_RETRIES + 1):
                try:
                    build_once()
                    break
                except OSError:
                    tevents.counter("cache.write_failures")
                    if attempt == BUILD_RETRIES:
                        raise
                    time.sleep(BUILD_BACKOFF_SECONDS)
    finally:
        # a failed build must not orphan its tmp bytes
        for leftover in tmps:
            try:
                os.remove(leftover)
            except OSError:
                pass  # renamed away (success) or never created
    return open_cache(path, layout=header.get("layout"),
                      expect_geom=header.get("geom"))


def open_or_build(path: str, *, header: dict, write_bin, aux=(),
                  legacy_geom: dict | None = None):
    """Reopen a complete cache whose header matches, else build it (a
    mismatched geometry raises from :func:`open_cache`)."""
    if exists(path):
        return open_cache(path, layout=header.get("layout"),
                          expect_geom=header.get("geom"),
                          legacy_geom=legacy_geom)
    return build_cache(path, header=header, write_bin=write_bin, aux=aux)
