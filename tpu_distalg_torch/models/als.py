"""ALS matrix factorisation (port of ``tpu_distalg/models/als.py``).

The fit on the emulated data × model mesh, as the JAX package runs it
under its ``als_train`` rule table (``parallel/partition.py``): R and
U are split over the data axis by rows, V over the model axis by rows
(``model_padded_n`` pads n so the split always engages), and every
half-sweep is a normal-equation solve against one k×k Gram
(``ops/linalg.py``). The psums the JAX partitioner inserts are sums
over the emulated shards in shard order (``parallel/collectives.py``):

  * U-update: the Gram VᵀV and each row shard's right-hand side Vᵀ·Rᵀ
    are sums over the model slices (each slice's rows of V against its
    columns of R), in model order;
  * V-update: each model slice solves its own rows; the Gram UᵀU and
    Uᵀ·R are sums over the data shards, in shard order;
  * the rmse's squared error is a sum over the (data, model) blocks.

The Gram and its solve run in float64, the products in float32. It
follows the JAX package step for step: the same V0 draw
(``default_rng(seed + 1)``, its random rows covering only the true n;
U0 is zeros and never read), the same sweep order (U-update, V-update,
then the rmse), the same ``reg_rows`` quirk (the U-update regularises
with the true ``n``, the V-update with the true ``m``), and the rmse
over the true m·n.

Across processes (a mesh whose data axis spans ``torch.distributed``
processes) a process holds its data shards' rows of R and U and every
model slice of V; the V-update's Gram and right-hand sides and the
rmse are psums over every data shard in global shard order
(``collectives.tree_allreduce_sum``, ``gather_shards``), so P processes
equal one process bit for bit, and the result's U is this process's
rows below the true m (:func:`own_rows`).

With ``checkpoint_dir`` the fit runs in segments through
``utils/checkpoint.run_segmented`` (tag ``"als"``, state ``(U, V)`` at
their padded shapes), which resumes from the directory and refuses a
checkpoint past ``n_iterations`` or of another workload or shape; the
last segment's checkpoint is the serving artifact
(``serve/artifacts.load_artifact``). Sweeps draw nothing, so a
segmented run equals a straight one bit for bit. :func:`fit_streamed`
runs the sweep over R streamed from a ``ShardedDataset`` (``data/``);
:func:`fit_rowstore` fits the observed entries with V in the cluster's
row store (``cluster/rowstore.py``). A failed segment is restarted
by ``utils/checkpoint.run_with_restarts`` (``als --max-restarts``),
resuming from the newest checkpoint.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from tpu_distalg_torch.ops import linalg
from tpu_distalg_torch.parallel import collectives, partition
from tpu_distalg_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from tpu_distalg_torch.parallel.sharding import pad_rows
from tpu_distalg_torch.utils import checkpoint, metrics


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    lam: float = 0.01
    m: int = 100
    n: int = 500
    k: int = 10
    n_iterations: int = 5
    seed: int = 0


@dataclasses.dataclass
class ALSResult:
    U: torch.Tensor
    V: torch.Tensor
    rmse_history: torch.Tensor  # per-sweep RMSE

    @property
    def final_rmse(self) -> float:
        return float(self.rmse_history[-1])


def synthesize_rank_k(config: ALSConfig) -> np.ndarray:
    """R = U₀·V₀ᵀ with U₀, V₀ ~ U[0,1) — the exactly-rank-k target."""
    rng = np.random.default_rng(config.seed)
    U0 = rng.random((config.m, config.k), dtype=np.float32)
    V0 = rng.random((config.n, config.k), dtype=np.float32)
    return U0 @ V0.T


def model_padded_n(config: ALSConfig, mesh: Mesh) -> int:
    """Columns of R (rows of V) after padding ``n`` up to a multiple of
    the model axis, so that V's split always engages. Padded columns are
    zero, so their V rows solve to exactly zero and touch neither the
    U-update's Gram nor the rmse."""
    return -(-config.n // mesh.n_model) * mesh.n_model


def make_fit_fn(mesh: Mesh, config: ALSConfig):
    """``fit(R, U0, V0) -> (U, V, rmse per sweep)`` for
    ``config.n_iterations`` sweeps on the mesh. R is (rows, cols), its
    rows a multiple of the data axis; with cols not a multiple of the
    model axis the split of V disengages, with the JAX package's
    warning, and V is held whole. Across processes R and U are this
    process's rows; V and the rmse are the same on every process."""
    denom = config.m * config.n  # the true element count
    n_model = mesh.n_model
    n_pad = model_padded_n(config, mesh)

    def _v_engaged(n_cols: int) -> bool:
        if n_model <= 1:
            return False
        if n_cols % n_model:
            warnings.warn(
                f"ALS model axis DISENGAGED: R has {n_cols} columns, "
                f"not a multiple of the model-axis size {n_model} — V "
                f"will be replicated. Pad R's columns to {n_pad} "
                "(als.fit does) to engage the model-parallel sharding.",
                stacklevel=3)
            return False
        return True

    def fit(R, U0, V0):
        vm = mesh if _v_engaged(R.shape[1]) else dataclasses.replace(
            mesh, n_model=1)
        # block (s, m): data shard s's rows of R, model slice m's columns
        # (this process's data shards)
        R_b = list(partition.shards(R, (DATA_AXIS, MODEL_AXIS),
                                    vm).values())

        def slices(V):
            return partition.shards(V, (MODEL_AXIS, None), vm)[
                mesh.local_data.start]

        U, V, errs = U0, V0, []
        for _ in range(config.n_iterations):
            # U-update: (VᵀV + λ·n·I) uᵢ = Vᵀ R[i, :], each psum over model
            V_m = slices(V)
            L = torch.linalg.cholesky(linalg.regularise(
                collectives.model_sum(linalg.gram_part(v) for v in V_m),
                config.lam, config.n))
            U_s = [linalg.solve_rhs(L, collectives.model_sum(
                v.T @ r.T for v, r in zip(V_m, row))) for row in R_b]
            # V-update: (UᵀU + λ·m·I) vⱼ = Uᵀ R[:, j]: the Gram and each
            # slice's right-hand side, one psum over the data shards
            G_u, *rhs = collectives.tree_allreduce_sum(
                ((linalg.gram_part(u),) + tuple(u.T @ r for r in row)
                 for u, row in zip(U_s, R_b)), mesh)
            L = torch.linalg.cholesky(linalg.regularise(G_u, config.lam,
                                                        config.m))
            V = torch.cat([linalg.solve_rhs(L, b) for b in rhs])
            U = torch.cat(U_s)
            # padded rows and columns are exactly zero on both sides;
            # the (data, model) blocks add in global shard order
            V_m = slices(V)
            blocks = collectives.gather_shards(
                (tuple(linalg.sq_err(r, u, v) for v, r in zip(V_m, row))
                 for u, row in zip(U_s, R_b)), mesh)
            sq = collectives.model_sum(x for per in blocks for x in per)
            errs.append(torch.sqrt(sq / denom))
        hist = torch.stack(errs) if errs else torch.zeros(
            0, dtype=torch.float32, device=R.device)
        return U, V, hist

    return fit


def fit(mesh: Mesh, config: ALSConfig = ALSConfig(),
        R: np.ndarray | None = None, *, checkpoint_dir: str | None = None,
        checkpoint_every: int = 5) -> ALSResult:
    """Fit U·Vᵀ ≈ R on the mesh's device (``cuda`` unless the mesh was
    built on ``cpu``); with ``checkpoint_dir``, in segments of
    ``checkpoint_every`` sweeps that resume from the directory. The
    result's U and V are cut back to the true m and n."""
    if R is None:
        R = synthesize_rank_k(config)
    elif R.shape != (config.m, config.n):
        # a caller's R wins: m and n set the rmse's denominator, the
        # ridge terms and the cut of U
        config = dataclasses.replace(config, m=R.shape[0], n=R.shape[1])
    R_padded, _ = pad_rows(np.asarray(R, dtype=np.float32), mesh.n_data)
    n_pad = model_padded_n(config, mesh)
    if n_pad != config.n:
        R_padded = np.pad(R_padded, ((0, 0), (0, n_pad - config.n)))
    rng = np.random.default_rng(config.seed + 1)
    U0 = np.zeros((R_padded.shape[0], config.k), dtype=np.float32)
    V0 = np.zeros((n_pad, config.k), dtype=np.float32)
    V0[:config.n] = rng.random((config.n, config.k), dtype=np.float32)

    R_dev = partition.put(R_padded, "R", "als_train", mesh)
    U_dev = partition.put(U0, "U", "als_train", mesh)
    V_dev = partition.put(V0, "V0", "als_train", mesh)
    if checkpoint_dir is None:
        U, V, errs = make_fit_fn(mesh, config)(R_dev, U_dev, V_dev)
        metrics.guard_finite(errs, "ALS rmse history")
        return ALSResult(U=own_rows(U, config.m, mesh), V=V[:config.n],
                         rmse_history=errs)

    def run_seg(fn, state, t0):
        del t0  # sweeps draw nothing; the factors are the whole state
        U, V, errs = fn(R_dev, *state)
        return (U, V), errs

    (U, V), errs, _ = checkpoint.run_segmented(
        checkpoint_dir, checkpoint_every, config.n_iterations,
        make_seg_fn=lambda seg: make_fit_fn(
            mesh, dataclasses.replace(config, n_iterations=seg)),
        run_seg=run_seg, state0=(U_dev, V_dev), tag="als", mesh=mesh,
        sharded=(True, False))
    return ALSResult(U=own_rows(U, config.m, mesh), V=V[:config.n],
                     rmse_history=torch.as_tensor(errs, device=mesh.device))


def own_rows(U: torch.Tensor, m: int, mesh: Mesh) -> torch.Tensor:
    """This process's block of a row-padded matrix cut to the true ``m``
    rows: ``U[:m]`` in one process; across processes the block's rows
    below global row ``m`` (the last processes may keep fewer, or
    none)."""
    lo = mesh.process_index * U.shape[0] if mesh.process_count > 1 else 0
    return U[:max(0, min(U.shape[0], m - lo))]


def fit_streamed(dataset, config: ALSConfig | None = None, *,
                 rmse_every: int = 1) -> ALSResult:
    """ALS over a :class:`~tpu_distalg_torch.data.ShardedDataset` of R's
    rows (``dense_rows_f32``), ``models/als.py:227-360`` of the JAX
    package: R is never resident. A sweep streams the row blocks once
    (one block a shard a step, through the prefetch pipeline): each
    block's U rows solve against the sweep's V (one float64 Cholesky
    factor of VᵀV + λ·n·I), and the contractions UᵀR (k, n, float32)
    and UᵀU (k, k, float64) accumulate over blocks, each block's shards
    added in shard order; V then solves against them (λ·m·I), as the
    resident sweep does with its n-column contraction spread over
    blocks. Across processes each process streams its own shards' blocks
    and holds their U rows; the contractions and the rmse are psums in
    global shard order. ``rmse_every=r`` streams one more pass for the rmse every
    r-th sweep (0: once, after the last sweep). The builder's zero
    padding rows solve to zero U rows and touch nothing; U is cut back
    to the true m. A run is bitwise equal across backends (the same
    staged bytes, the same ops)."""
    import contextlib

    from tpu_distalg_torch.telemetry import events as tevents

    meta, dev = dataset.meta, dataset.device
    m_true, n = int(meta.get("m", dataset.n2)), dataset.pd
    if config is None:
        config = ALSConfig(m=m_true, n=n, k=int(meta.get("k", 10)))
    if (config.m, config.n) != (m_true, n):
        config = dataclasses.replace(config, m=m_true, n=n)
    k, S = config.k, dataset.n_shards
    mesh, held = dataset.mesh, dataset.n_held
    rng = np.random.default_rng(config.seed + 1)
    V = torch.from_numpy(rng.random((n, k), dtype=np.float32)).to(dev)
    # every pass takes the blocks in order, block b on every shard
    ids = np.tile(np.arange(dataset.n_blocks, dtype=np.int64)[:, None, None],
                  (1, S, 1))
    denom = config.m * config.n
    errs = []
    for sweep in range(config.n_iterations):
        tevents.mark(f"als_stream:sweep@{sweep}", emit_event=False)
        L = torch.linalg.cholesky(linalg.regularise(
            linalg.gram_part(V), config.lam, n))
        C = torch.zeros((k, n), dtype=torch.float32, device=dev)
        UtU = torch.zeros((k, k), dtype=torch.float64, device=dev)
        us = []
        with contextlib.closing(dataset.stream(ids)) as batches:
            for staged in batches:
                U_b = [linalg.solve_rhs(L, V.T @ staged[s].T)
                       for s in range(held)]
                C_inc, UtU_inc = collectives.tree_allreduce_sum(
                    ((u.T @ staged[s], linalg.gram_part(u))
                     for s, u in enumerate(U_b)), mesh)
                C, UtU = C + C_inc, UtU + UtU_inc
                us.append(torch.stack(U_b))
        V = linalg.solve_rhs(torch.linalg.cholesky(linalg.regularise(
            UtU, config.lam, config.m)), C)
        if (rmse_every and (sweep + 1) % rmse_every == 0) or (
                sweep + 1 == config.n_iterations):
            sq = torch.zeros((), dtype=torch.float32, device=dev)
            with contextlib.closing(dataset.stream(ids)) as batches:
                for b, staged in enumerate(batches):
                    (part,) = collectives.tree_allreduce_sum(
                        ((linalg.sq_err(staged[s], us[b][s], V),)
                         for s in range(held)), mesh)
                    sq = sq + part
            errs.append(torch.sqrt(sq / denom))
    rows = dataset.n2_local * held
    U = (torch.stack(us, dim=1).reshape(rows, k) if us
         else torch.zeros((rows, k), dtype=torch.float32, device=dev))
    hist = torch.stack(errs) if errs else torch.zeros(
        (0,), dtype=torch.float32, device=dev)
    metrics.guard_finite(hist, "streamed ALS rmse history")
    return ALSResult(U=own_rows(U, config.m, mesh), V=V, rmse_history=hist)


def _padded(groups: list, values) -> tuple:
    """Rows of ragged index arrays ``groups`` as ``(idx (B, L) int64,
    mask (B, L) float64, vals (B, L) float64)`` zero-padded to the
    longest; ``values(i, g)`` gives row i's values at its indices."""
    L = max(int(g.shape[0]) for g in groups)
    idx = np.zeros((len(groups), L), np.int64)
    mask = np.zeros((len(groups), L), np.float64)
    vals = np.zeros((len(groups), L), np.float64)
    for i, g in enumerate(groups):
        idx[i, :g.shape[0]] = g
        mask[i, :g.shape[0]] = 1.0
        vals[i, :g.shape[0]] = values(i, g)
    return idx, mask, vals


def _solve_rows(F_all: torch.Tensor, idx, mask, r, lam: float
                ) -> torch.Tensor:
    """The per-row normal equations of one block, batched in float64:
    row b solves ``(FᵀF + λ·|obs_b|·I) x = Fᵀ r`` with ``F = F_all[idx[b]]``
    restricted to its observed entries (``mask``); padding rows of F are
    zero and add nothing."""
    k = F_all.shape[1]
    F = F_all[idx] * mask[..., None]
    Ft = F.transpose(1, 2)
    G = Ft @ F + (lam * mask.sum(1))[:, None, None] * torch.eye(
        k, dtype=torch.float64, device=F.device)
    return torch.linalg.solve(G, Ft @ (r * mask)[..., None])[..., 0]


def fit_rowstore(config: ALSConfig = ALSConfig(), *,
                 density: float = 0.08, ps_shards: int = 2,
                 user_block: int = 32,
                 model_budget_rows: int | None = None,
                 device=None) -> dict:
    """Observed-entry ALS with the item factor V living in the cluster's
    sharded row store (``cluster/rowstore.py``, table ``als_train``),
    port of ``tpu_distalg/models/als.py:363``. The worker holds U and
    the ratings and never materialises V whole: each user block's
    U-solves pull only the V rows that block's observed items reference,
    each item block's V-update pushes per-row deltas (one contribution
    at the store's own version: age 0, weight 1), and items nobody rated
    are never pulled, pushed or versioned.

    The host draws what the JAX package draws (the same R, observation
    mask, V0 and U0); the Grams and solves run on ``device`` (``cuda``
    unless told ``cpu``) in float64, a block's rows in one batched
    solve, and only the row store's pulls and pushes cross the host.
    ``model_budget_rows`` bounds the V rows any one pull materialises;
    a pull past it raises.

    Returns ``{U, V, rmse_history, peak_pull_rows, sparse_pull_fraction,
    rows_pulled, rows_pushed, row_versions}`` as numpy arrays and ints,
    the fraction being the rows pulled over the pull-everything
    baseline, V a final snapshot."""
    from tpu_distalg_torch.cluster import rowstore as _rowstore
    from tpu_distalg_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(config.seed)
    m, n, k, lam = config.m, config.n, config.k, config.lam
    R = synthesize_rank_k(config)
    observed = rng.random((m, n)) < density
    user_cols = [np.flatnonzero(observed[i]) for i in range(m)]
    item_users = [np.flatnonzero(observed[:, j]) for j in range(n)]
    touched_items = np.flatnonzero(observed.any(axis=0))
    n_obs = int(observed.sum())
    if not n_obs:
        raise ValueError("no observed entries at this density/seed")

    store = _rowstore.RowStore(
        {"V": rng.random((n, k), dtype=np.float32)},
        table="als_train", n_shards=ps_shards)
    U = rng.random((m, k), dtype=np.float32)

    def on_dev(*arrays):
        return tuple(torch.as_tensor(a, device=dev) for a in arrays)

    # each block's gather indices, masks and ratings, made once: the
    # observation pattern does not change between sweeps
    user_blocks = []
    for b0 in range(0, m, user_block):
        users = [i for i in range(b0, min(b0 + user_block, m))
                 if user_cols[i].size]
        if not users:
            continue
        need = np.unique(np.concatenate([user_cols[i] for i in users]))
        idx, mask, r = _padded(
            [np.searchsorted(need, user_cols[i]) for i in users],
            lambda t, _g, users=users: R[users[t], user_cols[users[t]]])
        user_blocks.append((np.asarray(users, np.int64), need,
                            *on_dev(idx, mask, r)))
    item_blk = (min(user_block * 4, model_budget_rows)
                if model_budget_rows else user_block * 4)
    item_blocks = []
    for t0 in range(0, touched_items.shape[0], item_blk):
        items = touched_items[t0:t0 + item_blk]
        idx, mask, r = _padded(
            [item_users[j] for j in items],
            lambda t, g, items=items: R[g, items[t]])
        item_blocks.append((items, *on_dev(idx, mask, r)))
    R_dev, obs_dev = on_dev(R, observed)

    peak_pull = 0
    rows_pulled = 0
    rows_pushed = 0
    n_pulls = 0

    def pull(rows: np.ndarray) -> np.ndarray:
        nonlocal peak_pull, rows_pulled, n_pulls
        if model_budget_rows is not None \
                and rows.shape[0] > model_budget_rows:
            raise RuntimeError(
                f"a pull needs {rows.shape[0]} V rows at once but the "
                f"model budget is {model_budget_rows} — shrink the "
                f"user blocks, not the honesty of the claim")
        peak_pull = max(peak_pull, int(rows.shape[0]))
        rows_pulled += int(rows.shape[0])
        n_pulls += 1
        vals, _vers = store.pull_rows("V", rows)
        return vals

    sq_errs = []
    U_dev = torch.as_tensor(U, device=dev)
    for _sweep in range(config.n_iterations):
        # U half-sweep: per user block, one pull of the union of its
        # observed item rows and one batched solve
        for users, need, idx, mask, r in user_blocks:
            V_blk = torch.as_tensor(pull(need), device=dev).double()
            U_dev[torch.as_tensor(users, device=dev)] = _solve_rows(
                V_blk, idx, mask, r, lam).float()
        # V half-sweep: per item block, solve the touched rows from the
        # local U and push the per-row deltas (the old values pulled
        # first: the delta is the wire object), blocked like the pulls
        U64 = U_dev.double()
        sq_err = torch.zeros((), dtype=torch.float64, device=dev)
        for items, idx, mask, r in item_blocks:
            old = pull(items)
            new_dev = _solve_rows(U64, idx, mask, r, lam).float()
            new = new_dev.cpu().numpy()
            store.merge_rows(store.version, [
                (0, {"V": (items, new - old, store.version)})])
            rows_pushed += int(items.shape[0])
            # observed-entry RMSE from the rows already in hand
            cols = torch.as_tensor(items, device=dev)
            pred = U_dev @ new_dev.T
            err = (pred - R_dev[:, cols]).double()[obs_dev[:, cols]]
            sq_err += torch.sum(err * err)
        sq_errs.append(sq_err)
    # one transfer after the sweeps (float64 sums, as the JAX
    # package's numpy loop adds them)
    errs = (np.sqrt(torch.stack(sq_errs).cpu().numpy() / n_obs)
            if sq_errs else [])

    dense_rows = n_pulls * n
    return {
        "U": U_dev.cpu().numpy(),
        "V": store.snapshot()["V"],
        "rmse_history": np.asarray(errs, np.float32),
        "peak_pull_rows": peak_pull,
        "sparse_pull_fraction": (rows_pulled / dense_rows
                                 if dense_rows else 0.0),
        "rows_pulled": rows_pulled,
        "rows_pushed": rows_pushed,
        "row_versions": store.row_versions("V"),
    }
