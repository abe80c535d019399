"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds)
and loaded with ``ctypes``. Builds go to ``build/kernels/`` beside the
package, named by a hash of the source and the flags, so a changed
source rebuilds and an unchanged one is loaded as it is. Nothing is
built when a module is imported: the first call that needs a kernel
builds it. A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
_L = ctypes.c_longlong
#: C signatures of every entry point, by library
_SIGNATURES = {
    "topk": {
        "tda_topk": ([_P, _P] + [_I] * 8 + [_P, _L, _P, _L, _P, _P, _I, _P],
                     _I),
        "tda_topk_layout": ([_I] * 5 + [_P], _I),
        "tda_error_string": ([_I], ctypes.c_char_p),
    },
    "ssgd": {
        "tda_ssgd_grad": ([_P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I,
                           _P], _I),
        "tda_ssgd_grad_gathered": ([_P, _I, _P, _I, _I, _I, _I, _I, _I, _P,
                                    _I, _I, _I, _I, _P, _P, _I, _P], _I),
        "tda_ssgd_grad_packed": ([_P, _I, _I, _I, _I, _I, _P, _U, _U, _U, _I,
                                  _P, _P, _I, _P], _I),
        "tda_ssgd_train": ([_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                            _F, _F, _I, _I, _I, _I, _I, _P, _P, _I, _P], _I),
        "tda_ssgd_forward_gathered": ([_P, _I, _P] + [_I] * 7
                                      + [_P, _I, _I, _I, _I, _P, _I, _P], _I),
        "tda_ssgd_backward_gathered": ([_P, _I, _P, _I, _I, _I, _I, _P, _I,
                                        _I, _P, _P, _I, _P], _I),
        "tda_error_string": ([_I], ctypes.c_char_p),
    },
    "pagerank": {
        "tda_pagerank_spmv": ([_P] * 4 + [_I, _I, _P, _I, _I] + [_P] * 3
                              + [_I, _P], _I),
        "tda_pagerank_segment_sum": ([_P, _P, _I, _I, _P, _I, _I] + [_P] * 3
                                     + [_I, _P], _I),
        "tda_pagerank_gather_ceiling": ([_P] * 4 + [_I, _I, _P, _I, _I, _P,
                                                    _I, _P], _I),
        "tda_error_string": ([_I], ctypes.c_char_p),
    },
    "kmeans": {
        "tda_kmeans_stats": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _P, _P, _P, _I, _P], _I),
        "tda_error_string": ([_I], ctypes.c_char_p),
    },
    "attention": {
        "tda_flash_fwd": ([_P] * 9 + [_I] * 7 + [_F, _I, _I, _I, _P], _I),
        "tda_flash_bwd": ([_P] * 9 + [_I] * 7 + [_F, _I, _I, _I, _P], _I),
        "tda_error_string": ([_I], ctypes.c_char_p),
    },
    "ssp": {
        "tda_straggle": ([_P, _I, _F, _P, _P], _I),
        "tda_error_string": ([_I], ctypes.c_char_p),
    },
}
#: the kernel libraries, built together by chip_smoke.py
LIBRARIES = tuple(_SIGNATURES)


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        src = f.read()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{h[:16]}.so")


def build(name: str) -> tuple | None:
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless the library is built
    already; returns ``(process, tmp_path, lib_path)``, or ``None`` when
    cached. Start several, then :func:`finish` each, to build in
    parallel."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
         os.path.join(CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def finish(started: tuple | None, timeout: float = 600.0) -> None:
    """Wait for a :func:`build`; raise with nvcc's output on failure,
    else move the library into place."""
    if started is None:
        return
    proc, tmp, out = started
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc did not finish within {timeout} s")
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc {proc.returncode}) building {out}:\n"
            f"{stderr}\n{stdout}")
    os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            finish(build(name))
            lib = ctypes.CDLL(_lib_path(name))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.tda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def check_tensor(name, t, dtypes, ndim) -> None:
    """Raise unless ``t`` is a tensor of one of ``dtypes`` with ``ndim``
    dimensions."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be {' or '.join(map(str, dtypes))},"
                         f" got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")


def cuda_device(*tensors):
    """The CUDA device of the operands (all on one card), or raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of card ``index``."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def stream(dev) -> int:
    """The current stream of ``dev`` in the calling thread, as the C entry
    points take it."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


#: the kernels' workspaces by (tag, device index, stream), grown when a
#: launch needs more; a new one is zeros
_WORKSPACES: dict = {}
_WORK_LOCK = threading.Lock()


def workspace(tag: str, dev, stream_: int, n: int, dtype):
    """A cached workspace of at least ``n`` elements of ``dtype`` for
    launches on ``stream_`` (launches on one stream run in order, so they
    may share it). Served models launch from their own dispatch threads:
    the cache is locked."""
    import torch

    key = (tag, dev.index, stream_)
    with _WORK_LOCK:
        ws = _WORKSPACES.get(key)
        if ws is None or ws.numel() < n:
            ws = torch.zeros((max(n, 1),), dtype=dtype, device=dev)
            _WORKSPACES[key] = ws
        return ws
