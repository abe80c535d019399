"""What the drivers share: the seeds of the program's calls, the
held-out matrix in the packed trainers' layout, and the reference's
view of the rows."""

from __future__ import annotations

import hashlib

import torch

from reference import compare, lr


def call_seed(seed: int, k: int) -> int:
    """The program's seed for its k-th call in a run of ``seed``: a
    31-bit number, the same for the same pair."""
    h = hashlib.sha256(f"{int(seed)}:{int(k)}".encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


def held_out_matrix(X_test, d_total: int, device) -> torch.Tensor:
    """(n_test, d_total) float32: the features, the bias column of ones,
    zeros in the columns the packed layout adds (its weights stay 0)."""
    n, f = X_test.shape
    out = torch.zeros((n, d_total), dtype=torch.float32, device=device)
    out[:, :f] = torch.from_numpy(X_test).to(device)
    out[:, f] = 1.0
    return out


def augmented(w0, d_total: int, device) -> torch.Tensor:
    out = torch.zeros((d_total,), dtype=torch.float32, device=device)
    out[:w0.shape[0]] = torch.from_numpy(w0).to(device)
    return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class TrainingDriver:
    """The reference side shared by the training drivers: the rows in a
    given precision (the data uploaded once), and the numbers compared.
    A driver sets ``cfg``, ``task``, ``br`` and ``dev``."""

    def rows(self, precision: dict) -> lr.Rows:
        cache = self.__dict__.setdefault("_rows", {})
        key = tuple(sorted(precision.items()))
        if key not in cache:
            any_rows = next(iter(cache.values()), None)
            X, y = ((any_rows.X, any_rows.y) if any_rows is not None else
                    (torch.from_numpy(self.task["X"]).to(self.dev),
                     torch.from_numpy(self.task["y"]).to(self.dev)))
            cache[key] = lr.Rows(X, y, self.br, precision)
        return cache[key]

    def numbers(self, side: dict, ref: dict) -> dict:
        """The numbers of ``side`` (the program's outputs, or another
        run put in its place) against the reference's ``ref``."""
        base = self.rows(self.cfg["precision"])
        return compare.training_numbers(
            n_features=self.cfg["n_features"], eta=self.cfg["eta"],
            w0=torch.from_numpy(self.task["w0"]).to(self.dev), prog=side,
            ref=ref, batches=[base.batch(i) for i in ref["first_ids"]])
