"""Drives SSGD's packed trainer, ``tpu_distalg_torch.models.ssgd``.

Set-up packs the rows once (``ssgd.prepare_fused``, the ``prepare``
span), then drives that one state through its first steps and its first
whole call with ``ssgd.train_prepared``, the window's own entry: three
calls of one step, then one of ``segment_steps`` (``mega_steps`` a
launch). The window runs more calls of ``segment_steps`` back to back,
each from the weights the last one left, under a seed of its own. The
reference follows the first three steps and the first whole call.
"""

from __future__ import annotations

import dataclasses

import torch

from harness import data, program
from reference import draws, follow

FIRST_STEPS = 3


class Driver(program.TrainingDriver):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed = config, traffic, int(seed)
        self.dev = torch.device(device)
        self.br = traffic["gather_block_rows"]
        self.n_blocks = draws.blocks_per_replica(config["n_train"], self.br)
        self.n_sampled = draws.sampled_blocks(self.n_blocks,
                                              traffic["fraction"])
        self.steps = traffic["segment_steps"]
        self.calls = 0

    # ------------------------------------------------------------ program

    def setup(self, spans) -> None:
        from tpu_distalg_torch.models import ssgd
        from tpu_distalg_torch.parallel import get_mesh

        self.task = data.lr_task(self.cfg, self.seed, self.dev)
        self.ssgd = ssgd
        self.mesh = get_mesh(data=1, device=self.dev)
        tr, mega = self.tr, self.tr["mega_steps"]
        self.base = ssgd.SSGDConfig(
            eta=self.cfg["eta"], mini_batch_fraction=self.tr["fraction"],
            lam=self.cfg["lam"], sampler=tr["sampler"],
            x_dtype=self.cfg["x_dtype"], fused_pack=tr["fused_pack"],
            gather_block_rows=self.br, n_iterations=self.steps,
            mega_steps=mega, eval_every=mega)
        with spans("prepare"):
            _, self.X2, _, self.meta = ssgd.prepare_fused(
                self.task["X"], self.task["y"], self.mesh, self.base)
            program.sync(self.dev)
        d_t = self.meta["d_total"]
        self.X_te = program.held_out_matrix(self.task["X_test"], d_t,
                                            self.dev)
        self.y_te = torch.from_numpy(self.task["y_test"]).to(self.dev)
        self.w = program.augmented(self.task["w0"], d_t, self.dev)
        first = [self._call(1)[0].clone() for _ in range(FIRST_STEPS)]
        w, acc = self._call(self.steps)
        self.prog = {"first": first, "segment": w.clone(),
                     "acc": float(acc)}

    def _call(self, steps: int):
        mega = min(self.tr["mega_steps"], steps)
        cfg = dataclasses.replace(
            self.base, n_iterations=steps, mega_steps=mega, eval_every=mega,
            seed=program.call_seed(self.seed, self.calls))
        self.calls += 1
        r = self.ssgd.train_prepared(self.mesh, cfg, self.X2, self.w,
                                     self.meta, self.X_te, self.y_te)
        self.w = r.w
        return r.w, r.accs[-1]

    def segment(self):
        """One window call; returns its seed."""
        seed = program.call_seed(self.seed, self.calls)
        self._call(self.steps)
        return seed

    def free(self) -> None:
        del self.X2, self.X_te, self.y_te, self.w
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- the count

    def work(self, tokens) -> dict:
        """Steps, launches and the rows whose gradient entered an update
        (padding rows excluded), of the window calls ``tokens``."""
        valid = draws.valid_rows_per_block(self.cfg["n_train"], self.br,
                                           self.n_blocks, self.dev)
        rows = 0
        for seed in tokens:
            ids = draws.step_draws(seed, 0, self.steps, self.n_blocks,
                                   self.n_sampled, self.dev)
            rows += int(valid[ids].sum())
        steps = len(tokens) * self.steps
        return {"steps": steps, "rows": rows, "rounds": 0,
                "launches": steps // self.tr["mega_steps"],
                "attempted": steps}

    # ---------------------------------------------------------- reference

    def reference(self, precision: dict | None = None, *,
                  keep: float = 1.0) -> dict:
        """The reference's run of the program's first steps and first
        whole call, in ``precision`` (default: the configuration's),
        with ``keep`` < 1 leaving out part of each batch."""
        from reference import lr

        rows = self.rows(precision or self.cfg["precision"])
        seeds = [program.call_seed(self.seed, k)
                 for k in range(FIRST_STEPS + 1)]
        w0 = torch.from_numpy(self.task["w0"]).to(self.dev)
        after, ids = follow.ssgd(
            rows, w0, [(s, 1) for s in seeds[:-1]] + [(seeds[-1],
                                                       self.steps)],
            n_blocks=self.n_blocks, n_sampled=self.n_sampled,
            eta=self.cfg["eta"], precision=rows.precision, keep=keep)
        X_te = torch.from_numpy(self.task["X_test"]).to(self.dev)
        y_te = torch.from_numpy(self.task["y_test"]).to(self.dev)
        return {"first": after[:-1], "segment": after[-1],
                "acc": lr.accuracy(after[-1], X_te, y_te),
                "first_ids": [i[0] for i in ids[:-1]]}
