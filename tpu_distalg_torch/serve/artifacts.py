"""Checkpoint → servable model (port of ``tpu_distalg/serve/artifacts.py``).

Three adapters. ALS: payload = one user id, reply = ``(scores (k_top,)
f32, item_ids (k_top,) int32)``; a batch runs ``U[ids]`` on the device,
then, per slice of the item factors over the mesh's model axis, the
fused matmul+top-k kernel (``ops/topk.py``), then the slices' candidate
merge (sparse pairs or dense score blocks), then ONE device→host copy.
LR: payload = one (d,) feature row, reply = P(y=1). K-means: payload =
one (dim,) point, reply = the nearest centre's index (int32). Every
batch is padded to ``max_batch`` rows, so batched and unbatched
requests run the same code and a reply does not depend on what else
was in its batch. A predictor packs the padded host batch first and
computes from it second (:class:`Predictor`), so a server across
processes can hand every process the same packed batch.

Across processes the factors are placed by the ``als_serve`` table: U
replicated (a training result's rows cross through
``partition.reshard``), V split over the model axis inside each
process, so every process computes every reply of a batch alike.

An artifact loads through :func:`_restore_with_reread` (JAX
``serve/artifacts.py:334-353``): a corrupt read (the ``ckpt:read``
seam flips bytes in flight) is read once more, since the file on disk is
usually intact, and only a second corrupt read falls back through the
quarantine path to an older step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.ops import kmeans as kops
from tpu_distalg_torch.ops import logistic, topk
from tpu_distalg_torch.parallel import comms, partition
from tpu_distalg_torch.parallel.mesh import Mesh
from tpu_distalg_torch.telemetry import events as tevents
from tpu_distalg_torch.utils import checkpoint
from tpu_distalg_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Predictor:
    """One batch size's predictor in two halves: ``pack(payloads)``
    checks the payloads and stacks them into the padded host batch (a
    numpy array; it raises on a bad payload), and ``run(packed, n)``
    computes the first ``n`` replies of a packed batch. A server across
    processes sends the packed batch between the two."""

    pack: object
    run: object

    def __call__(self, payloads):
        return self.run(self.pack(payloads), len(payloads))


@dataclasses.dataclass
class ServedModel:
    """One servable model: ``make_predict(max_batch)`` builds (once per
    batch size) the :class:`Predictor`, ``predict(payloads) -> [reply,
    ...]``."""

    name: str
    kind: str
    make_predict: object
    source: str = "memory"
    meta: dict = dataclasses.field(default_factory=dict)
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def predictor(self, max_batch: int):
        fn = self._cache.get(max_batch)
        if fn is None:
            fn = self._cache[max_batch] = self.make_predict(max_batch)
        return fn

    def predict_batch(self, payloads, max_batch: int):
        return self.predictor(max_batch)(payloads)

    def predict_one(self, payload, max_batch: int):
        """One request through the same padded predictor a full batch
        uses."""
        return self.predict_batch([payload], max_batch)[0]


def _stack_pad(payloads, shape: tuple, dtype, max_batch: int,
               what: str) -> np.ndarray:
    """Stack payloads into a (max_batch, *shape) array; zero rows pad
    the tail (inert: replies are sliced back to the request count)."""
    if len(payloads) > max_batch:
        raise ValueError(
            f"{what}: batch of {len(payloads)} exceeds max_batch="
            f"{max_batch}")
    out = np.zeros((max_batch,) + shape, dtype)
    for r, p in enumerate(payloads):
        arr = np.asarray(p, dtype)
        if arr.shape != shape:
            raise ValueError(
                f"{what}: payload {r} has shape {arr.shape}, "
                f"want {shape}")
        out[r] = arr
    return out


#: tag roots of the checkpoints whose first leaf is an LR weight vector
_LR_TAG_ROOTS = ("lr", "ssgd", "ma", "bmuf", "easgd", "local_sgd")


def _row_model(kind: str, name: str, source: str, dev, shape: tuple,
               score, meta: dict) -> ServedModel:
    """A model whose payload is one float32 row of ``shape`` and whose
    reply is ``score(X)[r]``, X the padded (max_batch, *shape) batch on
    the device; one device→host copy per batch."""
    def make_predict(max_batch: int):
        def pack(payloads):
            return _stack_pad(payloads, shape, np.float32, max_batch,
                              f"{kind}:{name}")

        def run(X, n):
            out = score(torch.as_tensor(X, device=dev)).cpu().numpy()
            return [out[r] for r in range(n)]

        return Predictor(pack, run)

    return ServedModel(name=name, kind=kind, make_predict=make_predict,
                       source=source, meta={**meta, "device": str(dev)})


def lr_model(w, name: str = "lr", *,
             device: str | torch.device | None = None,
             source: str = "memory") -> ServedModel:
    """Logistic scorer from a trained weight vector: reply = P(y=1)
    for one (d,) feature row."""
    dev = resolve_device(device)
    w_dev = torch.as_tensor(np.asarray(w), dtype=torch.float32, device=dev)
    if w_dev.dim() != 1:
        raise ValueError(f"w {tuple(w_dev.shape)}: want a vector")
    d = int(w_dev.shape[0])
    return _row_model("lr", name, source, dev, (d,),
                      lambda X: logistic.predict_proba(X, w_dev), {"d": d})


def kmeans_model(centers, name: str = "kmeans", *,
                 device: str | torch.device | None = None,
                 source: str = "memory") -> ServedModel:
    """Cluster assignment from trained centres: reply = the nearest
    centre's index (int32) for one (dim,) point."""
    dev = resolve_device(device)
    c_dev = torch.as_tensor(np.asarray(centers), dtype=torch.float32,
                            device=dev)
    if c_dev.dim() != 2:
        raise ValueError(f"centers {tuple(c_dev.shape)}: want (k, dim)")
    k, dim = int(c_dev.shape[0]), int(c_dev.shape[1])
    return _row_model(
        "kmeans", name, source, dev, (dim,),
        lambda X: kops.assign_clusters(X, c_dev).to(torch.int32),
        {"k": k, "dim": dim})


def _true_rows(M) -> int:
    """Count of leading rows up to the last non-zero one — the true
    item count of a factor matrix whose tail was zero-padded. On a
    device tensor only the resulting scalar crosses to the host."""
    M = torch.as_tensor(M)
    nz = torch.any(M != 0, dim=1)
    pos = torch.arange(1, M.shape[0] + 1, device=M.device)
    return int(torch.max(torch.where(nz, pos, 0))) if M.shape[0] else 0


def als_model(U, V, mesh: Mesh, *, k_top: int = 10, merge: str = "sparse",
              block_items: int | None = None, n_items: int | None = None,
              name: str = "als", source: str = "memory") -> ServedModel:
    """Top-k recommendation from ALS factors ``U`` (users, r) and ``V``
    (items, r), numpy arrays or tensors: payload = one user id, reply =
    ``(scores (k_top,) f32, item_ids (k_top,) int32)``, value
    descending, ties toward the lower id.

    V is padded to a multiple of the mesh's model axis and split into
    its slices; each slice scores its items, and the candidates merge
    by ``merge``:

      * ``'sparse'``: the top-k kernel (``ops/topk.py``) once per slice
        with the slice's ``index_offset`` and valid count, then
        ``comms.ring_allgather`` of the slices' (value, index) pairs
        (8·k·(S−1) wire bytes a request) and ``topk.merge_topk_pairs``;
      * ``'dense'``: each slice's whole score block (a matmul, no
        kernel), gathered (4·n_pad·(S−1)/S bytes a request), then the
        top k of the gathered rows: the baseline the sparse count is
        measured against.

    One slice is one kernel call over the whole V. The kernel's wrapper
    picks by device: the kernel on a CUDA tensor, its plain version on
    a CPU one (``meta['fused']`` says which). ``n_items`` overrides the
    true catalogue size; by default a zero-padded tail of V is detected
    and masked."""
    if merge not in ("sparse", "dense"):
        raise ValueError(f"merge must be 'sparse' or 'dense', "
                         f"got {merge!r}")
    dev = mesh.device
    # device-resident factors (a training result handed straight to
    # serving) take the train→serve reshard; host factors (a disk
    # artifact) are placed in the serving layout
    dev_in = isinstance(U, torch.Tensor) and isinstance(V, torch.Tensor)
    if dev_in:
        U = U.to(torch.float32)
        V = V.to(torch.float32)
    else:
        U = np.asarray(U, np.float32)
        V = np.asarray(V, np.float32)
    if U.ndim != 2 or V.ndim != 2 or U.shape[1] != V.shape[1]:
        raise ValueError(f"U {tuple(U.shape)} vs V {tuple(V.shape)}: "
                         f"factor ranks differ")
    n_true = int(n_items) if n_items is not None else _true_rows(V)
    if not 0 < n_true <= V.shape[0]:
        raise ValueError(
            f"n_items={n_true} invalid for V with {V.shape[0]} rows")
    if k_top < 1:
        raise ValueError(f"k_top must be >= 1, got {k_top}")
    n_model = mesh.n_model
    # every slice holds an equal share; padded rows are zero and masked
    n_pad = -(-V.shape[0] // n_model) * n_model
    if n_pad != V.shape[0]:
        V = (torch.nn.functional.pad(V, (0, 0, 0, n_pad - V.shape[0]))
             if dev_in else np.pad(V, ((0, n_pad - V.shape[0]), (0, 0))))
    local_n = n_pad // n_model
    if dev_in:
        placed = partition.reshard({"U": U, "V": V}, "als_train",
                                   "als_serve", mesh)
    else:
        placed = partition.place({"U": U, "V": V}, "als_serve", mesh)
    U_dev = placed["U"].contiguous()
    V_dev = placed["V"].contiguous()
    # the slices are views of V, never copies: a slice of a 16-byte
    # aligned V stays aligned when the rank is a multiple of 4, so it
    # takes the kernel's vector path as the whole V does
    V_sl = partition.shards(V_dev, partition.table("als_serve").spec_for(
        "V", tuple(V_dev.shape)), mesh)[mesh.local_data.start]

    def score(q, Vl, off, nv):
        return topk.fused_matmul_topk(q, Vl, off, nv, k=k_top,
                                      block_items=block_items)

    if n_model == 1:
        def topk_fn(q):
            return score(q, V_dev, 0, n_true)

        wire_per_req = 0
    elif merge == "sparse":
        def topk_fn(q):
            pairs = []
            for m, Vl in enumerate(V_sl):
                off = m * local_n
                pairs.append(score(q, Vl, off,
                                   min(max(n_true - off, 0), local_n)))
            all_v, all_i = comms.ring_allgather(pairs)
            return topk.merge_topk_pairs(all_v, all_i, k=k_top)

        wire_per_req = 8 * k_top * (n_model - 1)
    else:
        pos = torch.arange(n_pad, device=dev)

        def topk_fn(q):
            blocks = [torch.matmul(q, Vl.T) for Vl in V_sl]
            full = torch.where(pos[None, :] < n_true, torch.cat(blocks, 1),
                               float("-inf"))
            vals, idx = torch.sort(full, dim=1, descending=True,
                                   stable=True)
            return (vals[:, :k_top].contiguous(),
                    idx[:, :k_top].to(torch.int32))

        wire_per_req = 4 * n_pad * (n_model - 1) // n_model
    n_users = int(U_dev.shape[0])

    def make_predict(max_batch: int):
        wire_per_batch = wire_per_req * max_batch

        def pack(payloads):
            ids = _stack_pad(payloads, (), np.int64, max_batch,
                             f"als:{name}")
            if ids.min() < 0 or ids.max() >= n_users:
                raise ValueError(f"als:{name}: user id out of range "
                                 f"[0, {n_users})")
            return ids

        def run(ids, n):
            q = U_dev[torch.as_tensor(ids, device=dev)]
            vals, idx = topk_fn(q)
            # one device→host copy per batch: the int32 ids ride
            # bit-cast beside the float32 scores
            host = torch.cat((vals, idx.view(torch.float32)), 1).cpu()
            host = host.numpy()
            v = host[:, :k_top]
            i = np.ascontiguousarray(host[:, k_top:]).view(np.int32)
            if wire_per_batch:
                tevents.counter("serve.merge_bytes_wire", wire_per_batch)
            return [(v[r].copy(), i[r].copy()) for r in range(n)]

        return Predictor(pack, run)

    return ServedModel(
        name=name, kind="als", make_predict=make_predict, source=source,
        meta={"n_items": n_true, "n_users": n_users,
              "rank": int(U_dev.shape[1]), "k_top": k_top, "merge": merge,
              "fused": dev.type == "cuda", "n_model": n_model,
              "merge_wire_bytes_per_request": wire_per_req,
              "device": str(dev)})


def _restore_with_reread(path: str):
    """The newest checkpoint under ``path``: a corrupt read is read once
    more (``serve.artifact_reread``), and a second corrupt read falls
    back through ``checkpoint.restore_newest_with_fallback``."""
    try:
        return checkpoint.restore(path)
    except checkpoint.CorruptCheckpointError:
        tevents.counter("serve.artifact_reread")
        tevents.emit("serve_artifact_reread", path=path)
        try:
            return checkpoint.restore(path)
        except checkpoint.CorruptCheckpointError:
            out = checkpoint.restore_newest_with_fallback(path)
            if out is None:
                raise FileNotFoundError(
                    f"no restorable checkpoint under {path}") from None
            return out


def load_artifact(path: str, mesh: Mesh, *, name: str | None = None,
                  k_top: int = 10, merge: str = "sparse",
                  block_items: int | None = None) -> ServedModel:
    """Open one of the port's checkpoint directories as a
    :class:`ServedModel` on the mesh's device, dispatching on the
    checkpoint's tag; ALS factors are served over the mesh's model
    axis (:func:`als_model`). The read degrades as
    :func:`_restore_with_reread` says."""
    payload, step = _restore_with_reread(path)
    tag = payload["tag"]
    root = tag.split(":", 1)[0]
    tevents.emit("serve_artifact_loaded", path=path, tag=tag, step=step)
    if root in _LR_TAG_ROOTS:
        return lr_model(payload["state"][0], name=name or root,
                        device=mesh.device, source=path)
    if root.startswith("kmeans"):
        return kmeans_model(payload["state"][0], name=name or "kmeans",
                            device=mesh.device, source=path)
    if root == "als":
        U, V = payload["state"][:2]
        return als_model(U, V, mesh, k_top=k_top, merge=merge,
                         block_items=block_items, name=name or "als",
                         source=path)
    raise ValueError(
        f"checkpoint under {path} holds workload {root!r} — no serving "
        f"adapter for it (servable: {', '.join(_LR_TAG_ROOTS)}, kmeans_*, "
        f"als)")
