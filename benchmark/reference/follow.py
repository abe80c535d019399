"""The reference's run of what the program ran: the same draws from the
same seeds, the same starting weights, plain steps.

``ssgd`` follows a list of calls, each of ``steps`` minibatch steps
under its own seed (step ids from 0 in every call). ``model_average``
follows rounds ``t0 …`` of R replicas that each start from the center,
take L steps on their round's blocks, and are averaged. Both return
the weights after every call or round asked for, float32, in the
bias-last layout of the rows.

Planted faults, for the control tests and the calibration: ``keep``
(a share of each batch, the mean over it) and ``exchange=False`` (the
center becomes replica 0's model: no average across replicas).
"""

from __future__ import annotations

import torch

from reference import draws, lr


def ssgd(rows: lr.Rows, w0: torch.Tensor, calls, *, n_blocks: int,
         n_sampled: int, eta: float, precision: dict, keep: float = 1.0):
    """``calls``: a list of (seed, steps). Returns the weights after
    each call and each call's block ids, a (steps, n_sampled) tensor."""
    w, after, ids_of = w0.to(torch.float32).clone(), [], []
    for seed, steps in calls:
        ids = draws.step_draws(seed, 0, steps, n_blocks, n_sampled,
                               w0.device)
        for t in range(steps):
            x, y = rows.batch(ids[t])
            w = lr.sgd_step(w, x, y, eta, precision, keep)
        after.append(w.clone())
        ids_of.append(ids)
    return after, ids_of


def model_average(rows: lr.Rows, w0: torch.Tensor, *, seed: int, t0: int,
                  rounds: int, replicas: int, local_steps: int,
                  n_blocks: int, n_sampled: int, eta: float,
                  precision: dict, keep: float = 1.0,
                  exchange: bool = True, record=None):
    """Rounds ``t0 … t0 + rounds - 1`` from the center w0. Returns the
    center after each round in ``record`` (round counts from t0, 1-based;
    default: every round) and the rounds' block ids
    (rounds, replicas, n_sampled)."""
    ids = draws.round_draws(seed, t0, rounds, replicas, n_blocks,
                            n_sampled, w0.device)
    c = w0.to(torch.float32).clone()
    after = []
    for i in range(rounds):
        models = []
        for s in range(replicas):
            x, y = rows.batch(ids[i, s])
            w = c
            for _ in range(local_steps):
                w = lr.sgd_step(w, x, y, eta, precision, keep)
            models.append(w.to(torch.float64))
        c = (torch.stack(models).sum(0) / replicas if exchange
             else models[0]).to(torch.float32)
        if record is None or (i + 1) in record:
            after.append(c.clone())
    return after, ids
