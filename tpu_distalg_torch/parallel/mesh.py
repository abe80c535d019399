"""The data and model axes: emulated shards, one process or several.

Port of ``tpu_distalg/parallel/mesh.py``. The JAX package shards rows
over the ``data`` axis of a device mesh and, for SSGD's tensor-parallel
split, features over its ``model`` axis; here a :class:`Mesh` names how
many shards each axis has and the one device of this process that holds
its shards. Shard (s, m) is row slice ``s`` of model slice ``m``: the
``s``-th of ``n_data`` equal leading slices of a padded row array within
the ``m``-th of ``n_model`` contiguous column slices, as the rule
tables of :mod:`.partition` place them. A psum over either axis is a sum
over its shards in shard order (:mod:`.collectives`). The JAX package
also refuses more shards than devices; an emulated mesh has no such
limit.

Across processes (:func:`multihost_initialize`, ``torch.distributed``)
process ``p`` of ``P`` owns the contiguous block of global data shards
``[p·D/P, (p+1)·D/P)`` (:attr:`Mesh.local_data`), the row-major grid of
JAX's ``_topology_grid`` fallback (``tpu_distalg/parallel/mesh.py:136``),
and every model slice of those rows, as JAX's hybrid mesh keeps the
model axis inside a slice. :func:`emulate_devices` sets the emulated
shards a process holds when ``data`` is None. Unlike JAX's, it does not
force the CPU: ``--device`` still picks the device (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
import sys

import torch

from tpu_distalg_torch.utils import device as udevice
from tpu_distalg_torch.utils.device import resolve_device

#: the axis names the rule tables of ``parallel/partition.py`` use, as
#: the JAX package's ``parallel/mesh.py`` spells them
DATA_AXIS = "data"
MODEL_AXIS = "model"

#: seconds a rendezvous or a collective waits before it fails the run
DEFAULT_TIMEOUT_S = 300.0

#: emulated data shards a process holds when ``get_mesh(data=None)``
#: (:func:`emulate_devices`); None: one
_EMULATED: int | None = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_data`` × ``n_model`` emulated shards, of which this process
    (``process_index`` of ``process_count``) holds the data shards
    :attr:`local_data` and every model slice of them, on ``device``.
    ``distributed`` is True when the mesh spans a ``torch.distributed``
    process group, a group of one included: its psums then run the
    group's collectives."""

    n_data: int
    device: torch.device
    n_model: int = 1
    process_index: int = 0
    process_count: int = 1
    distributed: bool = False

    @property
    def n_local(self) -> int:
        """The data shards this process holds."""
        return self.n_data // self.process_count

    @property
    def local_data(self) -> range:
        """This process's global data shard ids, in order."""
        lo = self.process_index * self.n_local
        return range(lo, lo + self.n_local)


def emulate_devices(n: int) -> None:
    """Hold ``n`` emulated data shards in each process when a mesh is
    built with ``data=None`` (the JAX package's virtual host devices)."""
    global _EMULATED
    if int(n) < 1:
        raise ValueError(f"emulate_devices needs n >= 1, got {n}")
    _EMULATED = int(n)


def local_device_count() -> int:
    """Data shards this process holds by default: the emulated count, or
    one (one card a rank)."""
    return _EMULATED or 1


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def _host_names(store, rank: int, world: int) -> list[str]:
    """Every rank's host name, in rank order, traded through the
    rendezvous store (each rank writes its own, then reads all)."""
    import torch.distributed as dist

    hosts = dist.PrefixStore("tda/hosts", store)
    hosts.set(str(rank), socket.gethostname())
    return [hosts.get(str(r)).decode() for r in range(world)]


def multihost_initialize(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         device: str | torch.device | None = None,
                         timeout: float = DEFAULT_TIMEOUT_S) -> str:
    """Join this process to the process group; returns its backend.

    ``coordinator_address`` is process 0's ``host:port`` (a ``tcp://``
    rendezvous; an address with a scheme, such as ``file://``, is taken
    as it is) and needs ``num_processes`` and ``process_id``. With all
    three omitted the group comes from torchrun's environment
    (``env://``), the counterpart of the JAX package's auto-detection.
    The ranks trade their host names through the rendezvous store
    before the group is made: a rank's place among the ranks of its host
    picks its card (:func:`..utils.device.rank_card`), and their number
    the backend (:func:`..utils.device.choose_backend`); both are
    printed once. Idempotent, as the JAX package's is: a second call
    returns the running group's backend. Every rendezvous and collective
    fails after ``timeout`` seconds."""
    import torch.distributed as dist

    if _dist() is not None:
        return dist.get_backend()
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError(
                "--num-processes/--process-id require "
                "--coordinator-address (omit all three to auto-detect)")
        init_method, world, rank = "env://", -1, -1   # from the env
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    td = datetime.timedelta(seconds=timeout)
    store, rank, world = next(dist.rendezvous(init_method, rank, world,
                                              timeout=td))
    store.set_timeout(td)
    local_rank, local_world = udevice.host_layout(
        _host_names(store, rank, world), rank)
    udevice.set_process_rank(local_rank)
    dev = resolve_device(device)
    backend = udevice.choose_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            backend, store=dist.PrefixStore("default_pg", store),
            world_size=world, rank=rank, timeout=td)
    except BaseException:
        udevice.set_process_rank(None)
        raise
    # the connections (NCCL's communicator) are made here, not inside
    # the first psum
    dist.barrier(device_ids=[dev.index] if backend == "nccl" else None)
    print(f"[dist] rank {rank} of {world}: backend {backend}, device "
          f"{dev}", file=sys.stderr, flush=True)
    return backend


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    dist = _dist()
    if dist is not None:
        dist.destroy_process_group()
    udevice.set_process_rank(None)


def get_mesh(data: int | None = None, model: int = 1, *,
             device: str | torch.device | None = None) -> Mesh:
    """A mesh of ``data`` × ``model`` emulated shards on ``device``
    (``cuda`` unless told ``cpu``). ``data=None`` takes
    :func:`local_device_count` shards a process. In a process group the
    data shards split evenly over the processes; a count they do not
    divide raises."""
    n_proc = process_count()
    data = local_device_count() * n_proc if data is None else int(data)
    model = int(model)
    if data < 1:
        raise ValueError(f"data must be >= 1, got {data}")
    if model < 1:
        raise ValueError(f"model must be >= 1, got {model}")
    if data % n_proc:
        raise ValueError(
            f"{data} data shards do not split evenly over {n_proc} "
            f"processes: give a multiple of {n_proc}")
    return Mesh(n_data=data, device=resolve_device(device), n_model=model,
                process_index=process_index(), process_count=n_proc,
                distributed=_dist() is not None)
