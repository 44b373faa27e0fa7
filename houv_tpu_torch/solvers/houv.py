"""HOUV — Hybrid Optimization with Unconstrained Variables, in PyTorch.

Counterpart of ``houv_tpu/solvers/houv.py``, canonical objective (and its
``grad_mode='scatter'`` formulation):

- Each source/target pair is expanded to ``kernel`` random restarts, each
  with four unconstrained parameters: rotation axis ``v_c`` (3,), angle
  ``angle_c`` (1,), translation direction ``tran_c`` (3,) and scale
  ``tran_s`` (1,), all ~ N(0, 1); the first 26 axes sit on the 3x3x3
  integer lattice minus the origin.
- Sine reparametrization: angle = sin(angle_c·π)·π/8 + π/8 + base·π/4 (one
  45° window per angle base), tran_s = sin(tran_s·π).
- Loss = 6·min(cd_p, cd_t) of the 50%-truncated chamfer, rebuilt from
  matched rows: the nearest-neighbour search (``ops/chamfer.py``, a CUDA
  kernel on the card) runs once per refresh block without gradients, and
  the loss re-applies (R, T) to the gathered rows, so the backward is
  einsum transposes only. ``grad_mode='scatter'`` instead takes the loss
  through ``metrics/cd.py:calc_cd_percent`` on the transformed cloud, whose
  backward is the chamfer gradient's scatter-add (``ops/scatter.py``, a CUDA
  kernel on the card), and can add the projected ``loss_view`` terms.
- Adam(lr) for ``steps`` steps over all (pair, restart) replicas, phase by
  phase of the coarse-to-fine schedule (coarse phases run on FPS-downsampled
  clouds, ``ops/sampling.py``); the best restart wins.
- Hybrid retry, driven from the host: pairs whose best loss exceeds the
  threshold are solved again at angle bases 1..passes-1, keeping the better
  result.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from houv_tpu_torch._device import check_on, resolve_device
from houv_tpu_torch.geometry.rotations import (
    normalize_translation,
    rodrigues,
    rotation_error,
    rt_to_transformation,
    translation_error,
)
from houv_tpu_torch.metrics.cd import (
    _safe_sqrt,
    _smallest_k,
    calc_cd_percent,
    loss_view,
    smallest_k_sqrt_mean_fast,
)
from houv_tpu_torch.ops.chamfer import chamfer_indices
from houv_tpu_torch.ops.gather import gather_rows
from houv_tpu_torch.ops.sampling import furthest_point_sample

_PI = math.pi
_PARAM_NAMES = ("v_c", "angle_c", "tran_c", "tran_s")

# Options of the JAX solver that this port does not run yet, with the one
# value it accepts (ROADMAP.md, Queue 1: the solver ablations).
UNPORTED_DEFAULTS = {
    "objective": "trunc",
    "two_bracket": False,
    "nn_select": False,
    "voxel_downsample": None,
    "window_select": "loss",
    "rotation_mode": "axis_angle",
    "reparam": "sine",
}


@dataclasses.dataclass(frozen=True)
class HOUVConfig:
    """Solver hyperparameters (defaults = the canonical submission settings)."""

    kernel: int = 64          # random restarts per pair
    steps: int = 500          # Adam iterations
    lr: float = 0.1
    percent: float = 0.5      # truncated-CD keep fraction
    loss_weight: float = 6.0  # weight on the truncated-CD term
    tran_mode: str = "mvp"    # 'mvp': sin·1; 'bounded': 0.125+0.125·sin
    lattice_init: bool = True     # seed the first 26 axes on the lattice
    retry_threshold: float = 0.030
    angle_passes: int = 4     # angle bases 0..passes-1
    retry_mode: str = "threshold"  # 'threshold' | 'always' (every window)
    fast_trim: bool = True    # bisected truncated mean instead of top-k
    # Correspondence refresh: recompute the matches every nn_refresh steps
    # and reuse the matched rows in between (the matches are
    # piecewise-constant in (R, T)). The schedule, when set, overrides it:
    # (n_steps, refresh[, subsample]) phases summing to ``steps``, or
    # "auto" (auto_refresh_schedule).
    nn_refresh: int = 1
    nn_refresh_schedule: tuple | str | None = None
    # 'gather': one search, loss rebuilt from matched rows. 'scatter': the
    # chamfer op's own gradient (scatter-add backward); needs nn_refresh 1.
    grad_mode: str = "gather"
    # adds min(cd_p, cd_t) of the three axis projections; 'scatter' only
    use_view_loss: bool = False
    # Options that raise NotImplementedError unless left at their default
    # (UNPORTED_DEFAULTS).
    objective: str = "trunc"
    two_bracket: bool = False
    nn_select: bool = False
    voxel_downsample: int | None = None
    window_select: str = "loss"
    rotation_mode: str = "axis_angle"
    reparam: str = "sine"

    def __post_init__(self):
        for name, default in UNPORTED_DEFAULTS.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"HOUVConfig.{name}={getattr(self, name)!r} is not ported "
                    f"yet (only {default!r}); see ROADMAP.md Queue 1")
        if self.grad_mode not in ("gather", "scatter"):
            raise ValueError(f"unknown grad_mode {self.grad_mode!r}")
        if self.use_view_loss and self.grad_mode != "scatter":
            raise NotImplementedError(
                "use_view_loss is ported for grad_mode='scatter' only; "
                "see ROADMAP.md Queue 1, item 7c")
        if self.tran_mode not in ("mvp", "bounded"):
            raise ValueError(f"unknown tran_mode {self.tran_mode!r}")
        if self.retry_mode not in ("threshold", "always"):
            raise ValueError(f"unknown retry_mode {self.retry_mode!r}")


def init_params(generator: torch.Generator, batch: int, kernel: int,
                lattice_init: bool = True,
                device: str | torch.device = "cuda") -> dict:
    """Unconstrained parameters for (batch, kernel) replicas, drawn on the
    CPU from ``generator`` (so a seed gives the same restarts on every
    device) and moved to ``device``."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    v_c = normal(batch, kernel, 3)
    if lattice_init:
        lattice = torch.tensor(
            [(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1)
             for z in (-1, 0, 1) if (x, y, z) != (0, 0, 0)],
            dtype=torch.float32,
        )
        n_lat = min(26, kernel)
        v_c[:, :n_lat] = lattice[:n_lat]
    params = {
        "v_c": v_c,
        "angle_c": normal(batch, kernel, 1),
        "tran_c": normal(batch, kernel, 3),
        "tran_s": normal(batch, kernel, 1),
    }
    return {k: v.to(device) for k, v in params.items()}


def reparametrize(params: dict, angle_base: float, tran_mode: str = "mvp"):
    """Unconstrained params -> (R (B, K, 3, 3), T (B, K, 3)), sine windows."""
    angle = (torch.sin(params["angle_c"] * _PI) * (_PI / 8) + _PI / 8
             + angle_base * (_PI / 4))
    tran_s = torch.sin(params["tran_s"] * _PI)
    if tran_mode == "bounded":
        tran_s = tran_s * 0.125 + 0.125
    r = rodrigues(angle[..., 0], params["v_c"])
    t = normalize_translation(params["tran_c"], tran_s)
    return r, t


def _apply(src: torch.Tensor, r: torch.Tensor, t: torch.Tensor):
    """src (B, N, 3) × (B, K, 3, 3)/(B, K, 3) -> (B, K, N, 3)."""
    return torch.einsum("bnc,bkdc->bknd", src, r) + t[:, :, None, :]


def _trunc_mean_sqrt(d: torch.Tensor, k: int, fast: bool) -> torch.Tensor:
    if k >= d.shape[-1]:
        return _safe_sqrt(d).mean(-1)
    if fast:
        return smallest_k_sqrt_mean_fast(d, k)
    return _safe_sqrt(_smallest_k(d, k)).mean(-1)


def _pair_matches(src, tgt, src_t):
    """One nearest-neighbour pass -> matched rows, without gradients:
    tg (B, K, N, 3), the matched tgt row per src point, and s_sel
    (B, K, M, 3), the matched RAW src row per tgt point. Direction as in
    cd(gt=tgt, out=src_t): i1 is per tgt point, i2 per src point. Shared
    query layout: tgt (B, M, 3) serves the K restarts of its pair."""
    bsz, kernel, n = src_t.shape[:3]
    m = tgt.shape[1]
    i1, i2 = chamfer_indices(tgt, src_t.reshape(bsz * kernel, n, 3),
                             device=src.device)
    tg = gather_rows(tgt, i2.reshape(bsz, kernel * n)).reshape(
        bsz, kernel, n, 3)
    s_sel = gather_rows(src, i1.reshape(bsz, kernel * m)).reshape(
        bsz, kernel, m, 3)
    return tg, s_sel


def _dists_from_matches(tgt, src_t, tg, s_sel, r, t):
    """(d1 (B·K, M), d2 (B·K, N)) squared distances from matched rows,
    differentiable through (R, T) by einsum transposes only."""
    bsz, kernel, n = src_t.shape[:3]
    m = tgt.shape[1]
    d2 = ((src_t - tg) ** 2).sum(-1).reshape(bsz * kernel, n)
    matched_t = torch.einsum("bkmc,bkdc->bkmd", s_sel, r) + t[:, :, None, :]
    d1 = ((tgt[:, None] - matched_t) ** 2).sum(-1).reshape(bsz * kernel, m)
    return d1, d2


def _objective_matches(params, src, tgt, angle_base, cfg: HOUVConfig):
    """The match half of the objective: one search at the current (R, T)."""
    with torch.no_grad():
        r, t = reparametrize(params, angle_base, cfg.tran_mode)
        return _pair_matches(src, tgt, _apply(src, r, t))


def _objective_cached(params, matches, src, tgt, angle_base,
                      cfg: HOUVConfig):
    """Mean loss over all replicas and per-replica min_1 (B, K), rebuilt
    against cached matches."""
    tg, s_sel = matches
    r, t = reparametrize(params, angle_base, cfg.tran_mode)
    bsz, kernel = r.shape[:2]
    n = src.shape[1]
    src_t = _apply(src, r, t)
    d1, d2 = _dists_from_matches(tgt, src_t, tg, s_sel, r, t)
    # k from the OUTPUT (src) count for both sides, like calc_cd_percent
    k = int(n * cfg.percent)
    cd_p = _trunc_mean_sqrt(d1, k, cfg.fast_trim)
    cd_t = _trunc_mean_sqrt(d2, k, cfg.fast_trim)
    min_1 = torch.minimum(cd_p, cd_t)
    loss = cfg.loss_weight * min_1
    return loss.mean(), min_1.reshape(bsz, kernel)


def _objective_gather(params, src, tgt, angle_base, cfg: HOUVConfig):
    """The objective with matches at the current parameters (reference
    semantics: the argmin is piecewise-constant in (R, T))."""
    matches = _objective_matches(params, src, tgt, angle_base, cfg)
    return _objective_cached(params, matches, src, tgt, angle_base, cfg)


def _objective_scatter(params, src, tgt, angle_base, cfg: HOUVConfig):
    """The objective through the chamfer op's own gradient: the truncated
    CD of the transformed cloud against its pair's target, per replica, and
    with ``use_view_loss`` the three projected CDs."""
    r, t = reparametrize(params, angle_base, cfg.tran_mode)
    bsz, kernel = r.shape[:2]
    n = src.shape[1]
    src_t = _apply(src, r, t).reshape(bsz * kernel, n, 3)
    tgt_r = tgt[:, None].expand(bsz, kernel, -1, 3).reshape(
        bsz * kernel, -1, 3)
    cd_p, cd_t = calc_cd_percent(src_t, tgt_r, cfg.percent,
                                 fast=cfg.fast_trim)
    min_1 = torch.minimum(cd_p, cd_t)
    loss = cfg.loss_weight * min_1
    if cfg.use_view_loss:
        for dim in range(3):
            loss = loss + torch.minimum(*loss_view(src_t, tgt_r, dim=dim))
    return loss.mean(), min_1.reshape(bsz, kernel)


def _objective(params, src, tgt, angle_base, cfg: HOUVConfig):
    """Mean loss over all replicas and per-replica min_1 (B, K), matches
    taken at the current parameters."""
    if cfg.grad_mode == "gather":
        return _objective_gather(params, src, tgt, angle_base, cfg)
    return _objective_scatter(params, src, tgt, angle_base, cfg)


_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _adam_init(params: dict) -> dict:
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def _adam_update(params: dict, grads: dict, state: dict, lr: float):
    """One ``optax.adam(lr)`` step: bias-corrected moments, eps outside the
    sqrt. Returns the new params; updates ``state`` in place."""
    state["count"] += 1
    bc1 = 1.0 - _B1 ** state["count"]
    bc2 = 1.0 - _B2 ** state["count"]
    out = {}
    for name, p in params.items():
        g = grads[name]
        mu = (1 - _B1) * g + _B1 * state["mu"][name]
        nu = (1 - _B2) * (g * g) + _B2 * state["nu"][name]
        state["mu"][name], state["nu"][name] = mu, nu
        out[name] = p + -lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + _EPS))
    return out


def _adam_loop(src, tgt, angle_base, cfg: HOUVConfig, params: dict,
               opt_state: dict, n_steps: int):
    """``n_steps`` Adam steps over all replicas, matches recomputed once per
    block of ``cfg.nn_refresh`` steps (every step at refresh 1). Returns
    (params, opt_state, losses (n_steps,)), each loss taken before its
    step's update."""
    refresh = max(cfg.nn_refresh, 1)
    if n_steps % refresh:
        raise ValueError(
            f"step count {n_steps} not divisible by nn_refresh {refresh}")
    losses = []
    if cfg.grad_mode != "gather":
        if refresh > 1:
            raise NotImplementedError(
                "nn_refresh > 1 supports the canonical objective only "
                "(grad_mode='gather', use_view_loss=False)")
        for _ in range(n_steps):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            loss, _ = _objective_scatter(leaves, src, tgt, angle_base, cfg)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                params = _adam_update(params, dict(zip(leaves, grads)),
                                      opt_state, cfg.lr)
            losses.append(loss.detach())
        return params, opt_state, torch.stack(losses)
    for _ in range(n_steps // refresh):
        matches = _objective_matches(params, src, tgt, angle_base, cfg)
        for _ in range(refresh):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            loss, _ = _objective_cached(leaves, matches, src, tgt,
                                        angle_base, cfg)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                params = _adam_update(params, dict(zip(leaves, grads)),
                                      opt_state, cfg.lr)
            losses.append(loss.detach())
    return params, opt_state, torch.stack(losses)


def auto_refresh_schedule(steps: int) -> tuple:
    """Scale the coarse-to-fine split 300:5:4,150:5:2,50:2 of 500 steps to
    any budget; tiny budgets run one full-resolution phase at refresh 1."""
    if steps < 50:
        return ((steps, 1),)
    p1 = 5 * int(0.6 * steps / 5)
    p2 = 5 * int(0.3 * steps / 5)
    p3 = steps - p1 - p2
    r3 = 2 if p3 % 2 == 0 else 1
    return ((p1, 5, 4), (p2, 5, 2), (p3, r3))


def _refresh_phases(cfg: HOUVConfig) -> tuple:
    """The (n_steps, refresh, subsample) phases: the schedule when set, else
    one full-resolution phase at cfg.nn_refresh."""
    if cfg.nn_refresh_schedule is None:
        return ((cfg.steps, cfg.nn_refresh, 1),)
    if cfg.nn_refresh_schedule == "auto":
        return _refresh_phases(dataclasses.replace(
            cfg, nn_refresh_schedule=auto_refresh_schedule(cfg.steps)))
    phases = tuple(
        (int(p[0]), int(p[1]), int(p[2]) if len(p) > 2 else 1)
        for p in cfg.nn_refresh_schedule
    )
    total = sum(n for n, _, _ in phases)
    if total != cfg.steps:
        raise ValueError(
            f"nn_refresh_schedule phases sum to {total}, steps={cfg.steps}")
    if phases[-1][2] != 1:
        raise ValueError(
            "the final schedule phase must run at full resolution "
            "(subsample=1) — it sets the answer's precision")
    for n, r, _ in phases:
        if r > 1 and n % r:
            raise ValueError(
                f"schedule phase length {n} not divisible by its "
                f"nn_refresh {r}")
    return phases


def _phase_clouds(src: torch.Tensor, tgt: torch.Tensor, sub: int):
    """FPS-downsample both clouds by ``sub`` for a coarse phase."""
    if sub <= 1:
        return src, tgt

    def reduce(cloud):
        idx = furthest_point_sample(cloud, cloud.shape[1] // sub,
                                    device=cloud.device)
        return gather_rows(cloud, idx)

    return reduce(src), reduce(tgt)


def _best_restart(min_1: torch.Tensor):
    """(best value (B,), best index (B,)) over the restart axis."""
    idx = min_1.argmin(1)
    return min_1.gather(1, idx[:, None])[:, 0], idx


def houv_pass(src, tgt, params0: dict, angle_base: float, cfg: HOUVConfig):
    """One angle-window pass, phase by phase of the schedule. Returns
    (min_1 (B, K), R (B, K, 3, 3), T (B, K, 3)) at the final parameters."""
    params, opt_state = params0, _adam_init(params0)
    for n_steps, refresh, sub in _refresh_phases(cfg):
        cfg_r = dataclasses.replace(cfg, nn_refresh=refresh,
                                    nn_refresh_schedule=None)
        src_p, tgt_p = _phase_clouds(src, tgt, sub)
        params, opt_state, _ = _adam_loop(src_p, tgt_p, angle_base, cfg_r,
                                          params, opt_state, n_steps)
    with torch.no_grad():
        _, min_1 = _objective(params, src, tgt, angle_base, cfg)
        r, t = reparametrize(params, angle_base, cfg.tran_mode)
    return min_1, r, t


def houv_solve(src: torch.Tensor, tgt: torch.Tensor,
               cfg: HOUVConfig = HOUVConfig(), params0: dict | None = None,
               generator: torch.Generator | None = None,
               device: str | torch.device = "cuda") -> dict:
    """Full hybrid solve. src, tgt (B, N, 3) on ``device``. ``params0``
    (from ``init_params`` or ``state.params_from_jax``) fixes the restarts;
    else they are drawn from ``generator`` (seed 0 when None).

    Returns transform (B, 4, 4), rmse (B,) the best-restart loss, and
    n_retry, the number of pairs that entered the retry passes."""
    dev = resolve_device(device)
    check_on(dev, src, tgt)
    # the small rigid-transform einsums must run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    src = src.float()
    tgt = tgt.float()
    if params0 is None:
        generator = generator or torch.Generator().manual_seed(0)
        params0 = init_params(generator, src.shape[0], cfg.kernel,
                              cfg.lattice_init, device=dev)

    min_1, r, t = houv_pass(src, tgt, params0, 0.0, cfg)
    best, _ = _best_restart(min_1)
    if cfg.retry_mode == "always":
        retry_mask = torch.ones_like(best, dtype=torch.bool)
    else:
        retry_mask = best > cfg.retry_threshold
    n_retry = int(retry_mask.sum())
    if n_retry:
        for base in range(1, cfg.angle_passes):
            m2, r2, t2 = houv_pass(src, tgt, params0, float(base), cfg)
            best2, _ = _best_restart(m2)
            improved = retry_mask & (best2 < best)
            min_1 = torch.where(improved[:, None], m2, min_1)
            r = torch.where(improved[:, None, None, None], r2, r)
            t = torch.where(improved[:, None, None], t2, t)
            best = torch.where(improved, best2, best)

    _, idx = _best_restart(min_1)
    rows = torch.arange(src.shape[0], device=src.device)
    return {
        "transform": rt_to_transformation(r[rows, idx], t[rows, idx]),
        "rmse": best,
        "n_retry": n_retry,
    }


def combine(src: torch.Tensor, tgt: torch.Tensor,
            n_points: int = 2048) -> torch.Tensor:
    """FPS-merge two clouds back to n_points (concat, then FPS)."""
    merged = torch.cat([src, tgt], dim=1)
    idx = furthest_point_sample(merged, n_points, device=merged.device)
    return gather_rows(merged, idx)


def evaluate_solution(transform: torch.Tensor, pose_gt: torch.Tensor):
    """Rotation (degrees) and translation errors against 4x4 poses."""
    r_err = rotation_error(transform[:, :3, :3], pose_gt[:, :3, :3])
    t_err = translation_error(transform[:, :3, 3], pose_gt[:, :3, 3])
    return r_err, t_err
