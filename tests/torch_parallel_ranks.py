"""Rank functions of the port's multi-rank tests (``test_torch_parallel.py``,
``test_torch_distributed_train.py``): each runs inside a rank that
``houv_tpu_torch.parallel.distributed.launch`` started, on the CPU over
gloo, imports nothing of JAX (so that a rank starts quickly) and returns
numpy arrays in rank 0's record."""

from __future__ import annotations

import numpy as np
import torch

from houv_tpu_torch.parallel.mesh import (Mesh, all_gather_rows, make_mesh,
                                          make_mesh_2d, pick_across_restarts,
                                          sharded_houv_solve,
                                          sharded_houv_solve_2d)
from houv_tpu_torch.solvers.houv import HOUVConfig


def _numpy(out: dict) -> dict:
    return {k: v.numpy() if torch.is_tensor(v) else v for k, v in out.items()}


def replicas_equal(tensors, mesh: Mesh) -> bool:
    """Whether every rank holds the same values, bit for bit."""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in tensors])
    rows = all_gather_rows(flat[None], mesh).view(torch.int64)
    return bool((rows == rows[:1]).all())


def solves(src, tgt, cfg: HOUVConfig, seed: int, planted) -> dict:
    """Two ranks: the pair-sharded solve, the (2, 1) and (1, 2) restart
    splits, each from ``generator`` seeded by ``seed``; and the pick across
    the restart shards on ``planted`` (loss (B, W·K) pools, with ties)."""
    out = {}
    src, tgt = torch.as_tensor(src), torch.as_tensor(tgt)
    out["1d"] = _numpy(sharded_houv_solve(
        src, tgt, make_mesh(device="cpu"), cfg,
        generator=torch.Generator().manual_seed(seed)))
    for layout in ((2, 1), (1, 2)):
        mesh = make_mesh_2d(*layout, device="cpu")
        out[layout] = _numpy(sharded_houv_solve_2d(
            src, tgt, mesh, cfg,
            generator=torch.Generator().manual_seed(seed)))
    # the planted pools: each restart shard holds its restarts' columns
    mesh = make_mesh_2d(1, 2, device="cpu")
    loss = torch.as_tensor(planted["loss"])
    bsz, windows, kernel = loss.shape
    lk = kernel // 2
    ri = mesh.index("restart")
    mine = loss[:, :, ri * lk:(ri + 1) * lk].reshape(bsz, windows * lk)
    # a restart's rotation about z by its global index: the pick is read
    # back from the transform
    angle = torch.arange(kernel, dtype=torch.float32)[
        ri * lk:(ri + 1) * lk] * 0.01
    r = torch.zeros(bsz, windows, lk, 3, 3)
    r[..., 0, 0] = r[..., 1, 1] = torch.cos(angle)
    r[..., 0, 1], r[..., 1, 0] = -torch.sin(angle), torch.sin(angle)
    r[..., 2, 2] = 1.0
    t = torch.zeros(bsz, windows, lk, 3)
    t[..., 0] = torch.arange(windows, dtype=torch.float32)[:, None]
    transform, best = pick_across_restarts(
        mine, r.reshape(bsz, windows * lk, 3, 3),
        t.reshape(bsz, windows * lk, 3), lk, mesh,
        HOUVConfig(kernel=kernel))
    out["pick"] = {"transform": transform.numpy(), "best": best.numpy()}
    out["gathers"] = gathers()
    return out


def gathers() -> dict:
    """The row gather of a -0.0, NaN and subnormal row per rank, through
    ``all_gather`` and through the broadcasts that CUDA tensors take over
    gloo; and an integer SUM all-reduce."""
    import houv_tpu_torch.parallel.mesh as mesh_mod

    mesh = make_mesh(device="cpu")
    row = torch.tensor([[-0.0, float("nan"), 1e-45, float(mesh.rank)]])
    out = {"all_gather": all_gather_rows(row, mesh).numpy()}
    has_all_gather = mesh_mod._has_all_gather
    mesh_mod._has_all_gather = lambda group, t: False
    try:
        out["broadcasts"] = all_gather_rows(row, mesh).numpy()
    finally:
        mesh_mod._has_all_gather = has_all_gather
    out["sum_int"] = mesh_mod.sum_int(mesh.rank + 1, mesh)
    # the data-parallel gradient of a mean over the rows of a batch
    x = torch.linspace(-1.0, 1.0, 24, dtype=torch.float64).reshape(8, 3)
    loss, grads = mesh_mod.data_parallel_grads(
        lambda p, b: ((b @ p["w"]) ** 2).mean(),
        {"w": torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64)},
        mesh_mod.shard_batch(x, mesh), mesh)
    out["dp"] = (float(loss), grads["w"].numpy())
    return out


def rescored(src, tgt, cfg: HOUVConfig, params0: dict, state: dict,
             kw: dict, micro_batch: int) -> dict:
    """Two ranks: ``sharded_houv_solve_rescored`` with the sharded scorer
    of an ``AlignmentClassifier`` loaded from ``state``; and the sharded
    scorer on the whole batch's candidates that came back."""
    from houv_tpu_torch.models.alignment import AlignmentClassifier
    from houv_tpu_torch.solvers.rescore import (
        apply_candidates, make_sharded_classifier_scorer,
        sharded_houv_solve_rescored)

    mesh = make_mesh(device="cpu")
    model = AlignmentClassifier(grid_size=12, init_size=4)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    model.eval()
    scorer = make_sharded_classifier_scorer(model, mesh,
                                            micro_batch=micro_batch)
    src, tgt = torch.as_tensor(src), torch.as_tensor(tgt)
    out = sharded_houv_solve_rescored(
        src, tgt, mesh, cfg, scorer,
        params0={k: torch.as_tensor(v) for k, v in params0.items()}, **kw)
    moved = apply_candidates(src, out["cand_r"], out["cand_t"])
    logits = scorer(moved, tgt, out["cand_r"], out["cand_t"])
    return {**_numpy(out), "scorer_logits": logits.numpy(),
            "local_calls": scorer.local.calls}


def model_state(model) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def train_steps(raw: dict, n_steps: int, batch: dict, data_parallel: bool,
                dtype=torch.float32, state: dict | None = None):
    """``n_steps`` train steps of the trainer of config ``raw`` on the
    global ``batch``, from the seeded initialisation (or ``state``), on the
    CPU in ``dtype``; over the job's ranks when ``data_parallel``. Returns
    the losses, the first step's gradients, the final state and, over
    ranks, whether the replicas are equal."""
    from houv_tpu_torch.train.cli import make_trainer
    from houv_tpu_torch.train.config import Config

    mesh = make_mesh(device="cpu") if data_parallel else None
    trainer = make_trainer(Config.from_dict(raw), "cpu", mesh)
    trainer.init_state()
    if state is not None:
        trainer.model.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state.items()})
    trainer.model.to(dtype)
    if dtype == torch.float64:
        batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                 for k, v in batch.items()}
    # under use_gan the critic's gradients and state too, as "critic.*"
    modules = {"": trainer.model}
    if getattr(trainer, "critic", None) is not None:
        modules["critic."] = trainer.critic
    losses = [float(trainer.train_step(batch, 0, 0))]
    grads = {prefix + k: p.grad.detach().numpy().copy()
             for prefix, m in modules.items()
             for k, p in m.named_parameters() if p.grad is not None}
    losses += [float(trainer.train_step(batch, 0, s))
               for s in range(1, n_steps)]
    out = {"losses": np.asarray(losses), "grads": grads,
           "state": {prefix + k: v for prefix, m in modules.items()
                     for k, v in model_state(m).items()}}
    if mesh is not None:
        out["replicas_equal"] = replicas_equal(
            [v for m in modules.values() for v in m.state_dict().values()],
            mesh)
        out["ranks"] = trainer.mesh.size       # the trainer kept the mesh
    return out


def train_cases(cases: dict) -> dict:
    """``train_steps`` over the ranks for each case: name -> its
    arguments after ``data_parallel``."""
    return {name: train_steps(raw, n, batch, True, *rest)
            for name, (raw, n, batch, *rest) in cases.items()}
