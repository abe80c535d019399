"""Drives the local-update trainer, ``tpu_distalg_torch.models.local_sgd``
(model averaging, BMUF and EASGD share it), on emulated replicas.

Set-up packs the rows once (``local_sgd.prepare_fused``, the
``prepare`` span) and builds the trainer with
``local_sgd.make_train_fn_fused``; it drives that state through its
first rounds one call a round, then its first whole call of
``segment_rounds`` rounds. The window runs more calls back to back,
carrying the center, the replicas, δ and the round id forward. The
reference follows the first three rounds and the first whole call; it
knows the average (``global_update`` "average") and no other combine.
"""

from __future__ import annotations

import dataclasses

import torch

from harness import data, program
from reference import draws, follow

FIRST_ROUNDS = 3


class Driver(program.TrainingDriver):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        if traffic["global_update"] != "average":
            raise ValueError(f"the reference follows model averaging only, "
                             f"not {traffic['global_update']!r}")
        self.cfg, self.tr, self.seed = config, traffic, int(seed)
        self.dev = torch.device(device)
        self.br = traffic["gather_block_rows"]
        self.R = traffic["replicas"]
        self.L = traffic["local_steps"]
        self.n_blocks = draws.blocks_per_replica(config["n_train"], self.br,
                                                 self.R)
        self.n_sampled = draws.sampled_blocks(self.n_blocks,
                                              traffic["fraction"])
        self.rounds = traffic["segment_rounds"]
        self.prog_seed = program.call_seed(self.seed, 0)
        self.t = 0

    # ------------------------------------------------------------ program

    def setup(self, spans) -> None:
        from tpu_distalg_torch.models import local_sgd
        from tpu_distalg_torch.parallel import get_mesh

        self.task = data.lr_task(self.cfg, self.seed, self.dev)
        self.mesh = get_mesh(data=self.R, device=self.dev)
        tr = self.tr
        cfg = local_sgd.LocalSGDConfig(
            n_iterations=self.rounds, n_local_iterations=self.L,
            eta=self.cfg["eta"], mini_batch_fraction=self.tr["fraction"],
            global_update=tr["global_update"], sampler=tr["sampler"],
            x_dtype=self.cfg["x_dtype"], fused_pack=tr["fused_pack"],
            gather_block_rows=self.br, seed=self.prog_seed)
        with spans("prepare"):
            self.fn, self.X2, _, _, _, meta = local_sgd.prepare_fused(
                self.task["X"], self.task["y"], self.mesh, cfg)
            program.sync(self.dev)
        one = local_sgd.make_train_fn_fused(
            self.mesh, dataclasses.replace(cfg, n_iterations=1), meta)
        d_t = meta["d_total"]
        self.X_te = program.held_out_matrix(self.task["X_test"], d_t,
                                            self.dev)
        self.y_te = torch.from_numpy(self.task["y_test"]).to(self.dev)
        self.state = (program.augmented(self.task["w0"], d_t, self.dev),
                      torch.zeros((self.R, d_t), dtype=torch.float32,
                                  device=self.dev),
                      torch.zeros((d_t,), dtype=torch.float32,
                                  device=self.dev))
        first = [self._call(one, 1)[0].clone() for _ in range(FIRST_ROUNDS)]
        w, acc = self._call(self.fn, self.rounds)
        self.prog = {"first": first, "segment": w.clone(),
                     "acc": float(acc)}

    def _call(self, fn, rounds: int):
        w, ws, delta, accs = fn(self.X2, self.X_te, self.y_te, *self.state,
                                t0=self.t)
        self.state = (w, ws, delta)
        self.t += rounds
        return w, accs[-1]

    def segment(self):
        """One window call; returns its first round."""
        t0 = self.t
        self._call(self.fn, self.rounds)
        return t0

    def free(self) -> None:
        del self.X2, self.X_te, self.y_te, self.state, self.fn
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- the count

    def work(self, tokens) -> dict:
        """Rounds, local steps, launches and the rows whose gradient
        entered an update (padding rows excluded), of the window calls
        starting at the rounds ``tokens``."""
        valid = draws.valid_rows_per_block(
            self.cfg["n_train"], self.br, self.n_blocks * self.R, self.dev)
        rows = 0
        for t0 in tokens:
            ids = draws.round_draws(self.prog_seed, t0, self.rounds, self.R,
                                    self.n_blocks, self.n_sampled, self.dev)
            rows += int(valid[ids].sum()) * self.L
        rounds = len(tokens) * self.rounds
        return {"steps": rounds * self.R * self.L, "rows": rows,
                "rounds": rounds, "launches": rounds * self.R,
                "attempted": rounds}

    # ---------------------------------------------------------- reference

    def reference(self, precision: dict | None = None, *,
                  keep: float = 1.0, exchange: bool = True) -> dict:
        """The reference's run of the first rounds and the first whole
        call, in ``precision`` (default: the configuration's); ``keep``
        and ``exchange`` plant faults (:mod:`reference.follow`)."""
        from reference import lr

        rows = self.rows(precision or self.cfg["precision"])
        kw = dict(seed=self.prog_seed, replicas=self.R,
                  local_steps=self.L, n_blocks=self.n_blocks,
                  n_sampled=self.n_sampled, eta=self.cfg["eta"],
                  precision=rows.precision, keep=keep, exchange=exchange)
        w0 = torch.from_numpy(self.task["w0"]).to(self.dev)
        first, ids = follow.model_average(rows, w0, t0=0,
                                          rounds=FIRST_ROUNDS, **kw)
        (seg,), _ = follow.model_average(
            rows, first[-1], t0=FIRST_ROUNDS, rounds=self.rounds,
            record={self.rounds}, **kw)
        X_te = torch.from_numpy(self.task["X_test"]).to(self.dev)
        y_te = torch.from_numpy(self.task["y_test"]).to(self.dev)
        return {"first": first, "segment": seg,
                "acc": lr.accuracy(seg, X_te, y_te),
                "first_ids": [i.reshape(-1) for i in ids]}
