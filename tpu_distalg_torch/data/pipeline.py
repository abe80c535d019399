"""The prefetch pipeline: gather ∥ H2D ∥ compute.

Port of ``tpu_distalg/data/pipeline.py``. The host gather of batch t+2
runs on a background producer thread behind a one-deep queue, the H2D
copy of batch t+1 is issued (on the dataset's side stream, on a card)
before batch t is handed to the consumer, and the steady-state rate is
``max(gather, H2D, compute)``, not their sum. The contract, as in the
JAX package:

  * block order and content equal the serial path's: the producer
    gathers ``ids[0], ids[1], ...`` in order;
  * host residency is bounded: one gathered batch in the queue, one
    being gathered, one being copied (the three pinned buffers of
    ``sharded.py`` on a card);
  * a producer exception is forwarded through the queue and raised in
    the consumer; on any exit the producer is halted and joined;
  * a producer that dies without posting anything (an injected
    ``faults.InjectedKill``) does not hang the consumer:
    :meth:`Prefetcher.get` polls the producer's liveness and raises
    :class:`ProducerDiedError`.

:func:`make_host_block_sampler` is the ``fused_gather`` block draw the
host gathers by: the port's threefry is exact int64 arithmetic, so its
ids equal the ones the resident path draws on the card
(``models/ssgd.py:_block_draws``) and the JAX package's, whether they
are hashed on the CPU or, for a trainer on the card, there.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from tpu_distalg_torch import faults
from tpu_distalg_torch.telemetry import events as tevents


class ProducerDiedError(RuntimeError):
    """The prefetch producer exited without posting the item (or the
    error) the consumer waits for."""


class Prefetcher:
    """One-deep background producer: ``produce(i)`` for ``i in
    range(n_items)`` arrives in order behind a maxsize-1 queue;
    :meth:`get` returns the next item or raises the producer's
    exception. A context manager: ``__exit__`` halts and joins the
    thread whatever the queue holds."""

    #: how often :meth:`get` checks that the producer is alive
    POLL_SECONDS = 0.1

    def __init__(self, produce, n_items: int,
                 name: str = "tda-data-prefetch"):
        self._produce = produce
        self._n = int(n_items)
        self._halt = threading.Event()
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._thread = (threading.Thread(target=self._run, daemon=True,
                                         name=name)
                        if self._n else None)

    def _offer(self, item) -> bool:
        while not self._halt.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for i in range(self._n):
                if not self._offer(self._produce(i)):
                    return
        except faults.InjectedKill:
            # the chaos model of a producer killed mid-flight: die
            # silently; get()'s liveness check turns it into an error
            return
        except BaseException as e:  # noqa: BLE001 — raised in get()
            self._offer(e)

    def get(self):
        """The next item, or the producer's forwarded exception; a dead
        producer raises :class:`ProducerDiedError` (a hung but living
        one is still waited on)."""
        while True:
            try:
                item = self._q.get(timeout=self.POLL_SECONDS)
                break
            except queue.Empty:
                th = self._thread
                if th is None or not th.is_alive():
                    # it may have posted between the timeout and the check
                    try:
                        item = self._q.get_nowait()
                        break
                    except queue.Empty:
                        tevents.counter("faults.producer_deaths_detected")
                        what = ("was never started" if th is None
                                else f"{th.name} died")
                        raise ProducerDiedError(
                            f"prefetch producer thread {what} without "
                            f"posting an item or an error; the batch it "
                            f"owed will never arrive — restart the "
                            f"stream") from None
        if isinstance(item, BaseException):
            raise item
        return item

    def __enter__(self):
        if self._thread is not None:
            self._thread.start()
        return self

    def __exit__(self, *exc):
        self._halt.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        return False


def stream_staged(dataset, ids):
    """Yield one staged batch per step of ``ids`` ``(T, S, ns)``.

    Host backends: the producer gathers batch t+2 (into a pinned buffer
    on a card) while batch t+1's copy is in flight and the consumer
    computes on batch t; the compute stream waits for a batch's copy
    only when that batch is yielded. Resident: block takes on the
    device. Each step updates the ``data:stream`` mark; at the end one
    ``data_pipeline`` event records the steps and bytes."""
    n_steps = len(ids)
    if dataset.backend == "resident":
        for i in range(n_steps):
            tevents.mark("data:stream", emit_event=False)
            yield dataset.stage(ids[i])
        return
    total_bytes = 0
    with Prefetcher(lambda i: dataset.host_batch(ids[i]), n_steps) as pf:
        nxt = dataset.put_async(pf.get()) if n_steps else None
        for i in range(n_steps):
            tevents.mark("data:stream", emit_event=False)
            staged, ready = nxt
            nxt = dataset.put_async(pf.get()) if i + 1 < n_steps else None
            dataset.wait(ready)
            total_bytes += staged.numel() * staged.element_size()
            yield staged
            del staged   # its memory goes back once the consumer is done
    tevents.emit("data_pipeline", backend=dataset.backend, steps=n_steps,
                 bytes=total_bytes)


#: threefry words one group of steps' block draws takes at once (bounds
#: the hash's int64 temporaries near 128 MB each)
DRAW_WORDS_PER_GROUP = 1 << 24


def make_host_block_sampler(seed: int, n_shards: int, n_blocks: int,
                            n_sampled: int, device="cpu"):
    """The ``fused_gather`` block draw for the host's gathers:
    ``draw(ts) -> (T, n_shards, n_sampled)`` int32 local block ids, as
    numpy, for the absolute steps ``ts``; equal to the resident path's
    draws and to the JAX package's ``make_host_block_sampler`` (the
    port's threefry is exact int64 arithmetic on any device). The words
    are hashed on ``device`` (the card's trainers pass theirs: the
    draws of a run cost one copy back instead of the host's threefry),
    a group of steps at a time."""
    from tpu_distalg_torch.ops import sampling
    from tpu_distalg_torch.utils import prng

    key = prng.root_key(seed, device)
    group = max(1, DRAW_WORDS_PER_GROUP // max(1, n_shards * n_blocks))

    def draw(ts) -> np.ndarray:
        t = torch.as_tensor(np.asarray(ts), dtype=torch.int64)
        parts = [sampling.sample_block_ids(
            prng.fold_in(key, t[lo:lo + group].to(key.device)), n_shards,
            n_blocks, n_sampled).cpu()
            for lo in range(0, max(1, t.shape[0]), group)]
        return torch.cat(parts).numpy()

    return draw
