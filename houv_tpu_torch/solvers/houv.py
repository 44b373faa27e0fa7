"""HOUV — Hybrid Optimization with Unconstrained Variables, in PyTorch.

Counterpart of ``houv_tpu/solvers/houv.py``: the canonical objective (and
its ``grad_mode='scatter'`` formulation) and the JAX solver's ablations
(below the list):

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
  kernel on the card). ``use_view_loss`` adds min(vp, vt) of the three
  axis-projected CDs, in either mode: under 'gather' each is one more search
  on the projected clouds, its loss rebuilt from matched rows the same way.
  ``nn_select=True`` takes the matched rows as coordinates straight from
  the search (``ops/chamfer.py:nn_select``, a CUDA kernel on the card)
  instead of indices and row gathers.
- Adam(lr) for ``steps`` steps over all (pair, restart) replicas, phase by
  phase of the coarse-to-fine schedule (coarse phases run on FPS-downsampled
  clouds, ``ops/sampling.py``); the best restart wins.
- Hybrid retry, driven from the host: pairs whose best loss exceeds the
  threshold are solved again at angle bases 1..passes-1, and the restart of
  least loss over the windows wins (``houv_candidate_pools`` keeps every
  restart of every window, for the rescored selection).

The ablations, each as the JAX solver runs it: ``reparam`` 'sigmoid',
'v3' and 'unconstrained' windows; ``rotation_mode='euler'`` (Rx·Ry·Rz of
the ``angle_xyz`` parameters, which every restart carries and Adam steps
in every mode: unused, they keep a zero gradient and stay put);
``two_bracket`` (the restart axis halved, the second half one window up,
both halves lattice-seeded, bracket 0 kept unless bracket 1 is better by
``bracket_preference``); ``objective='multi_percent'`` (min-CDs at 100%,
30% and 10% and the three view CDs, each extra term weighted by a
detached ratio to the full one, restarts ranked by the 10% one: three
view searches a step beside the main one); ``select_percent`` (restarts
and windows ranked by the CD at another keep fraction);
``window_select='consensus'`` (each window's best restart carries the
count of restarts that agree with it, and the best-agreed window within
``consensus_window_ratio`` of the best loss wins); ``voxel_downsample``
(each cloud replaced by its voxel means, ``ops/voxel.py:voxelize_mean``
on the K4 scatter, repeated to the cloud's size).
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
    rotation_xyz,
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
from houv_tpu_torch.ops.chamfer import chamfer_indices, nn_select
from houv_tpu_torch.ops.gather import gather_rows
from houv_tpu_torch.ops.sampling import furthest_point_sample
from houv_tpu_torch.ops.voxel import voxelize_mean

_PI = math.pi
_PARAM_NAMES = ("v_c", "angle_c", "tran_c", "tran_s", "angle_xyz")
_REPARAMS = ("sine", "sigmoid", "unconstrained", "v3")


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
    # adds min(vp, vt) of the three axis-projected CDs (one more search each)
    use_view_loss: bool = False
    # 'gather' only: the search emits the matched neighbours' coordinates
    # (ops/chamfer.py:nn_select) instead of indices for two row gathers; the
    # matched raw src rows are recovered as R0^T (c1 - t0)
    nn_select: bool = False
    # The ablations (see the module's note). 'sine' | 'sigmoid' |
    # 'unconstrained' | 'v3'; 'axis_angle' | 'euler'
    reparam: str = "sine"
    rotation_mode: str = "axis_angle"
    # voxel grid size of the input reduction (None: the clouds as given)
    voxel_downsample: int | None = None
    # 'trunc' (canonical) | 'multi_percent'; the latter and select_percent
    # need grad_mode='gather'
    objective: str = "trunc"
    two_bracket: bool = False
    bracket_preference: float = 1.3  # rmse1 < 1.3·rmse2 keeps bracket 0
    select_percent: float | None = None
    # 'loss' (keep the window of least loss) | 'consensus'
    window_select: str = "loss"
    consensus_angle: float = 15.0
    consensus_loss_ratio: float = 1.3
    consensus_window_ratio: float = 1.5

    def __post_init__(self):
        if self.reparam not in _REPARAMS:
            raise ValueError(f"unknown reparam {self.reparam!r}")
        if self.window_select not in ("loss", "consensus"):
            raise ValueError(
                f"unknown window_select {self.window_select!r}")
        if self.grad_mode not in ("gather", "scatter"):
            raise ValueError(f"unknown grad_mode {self.grad_mode!r}")
        if self.nn_select and self.grad_mode != "gather":
            raise ValueError("nn_select applies to grad_mode='gather' only")
        if self.tran_mode not in ("mvp", "bounded"):
            raise ValueError(f"unknown tran_mode {self.tran_mode!r}")
        if self.retry_mode not in ("threshold", "always"):
            raise ValueError(f"unknown retry_mode {self.retry_mode!r}")


def init_params(generator: torch.Generator, batch: int, kernel: int,
                lattice_init: bool = True, two_bracket: bool = False,
                device: str | torch.device = "cuda") -> dict:
    """Unconstrained parameters for (batch, kernel) replicas, drawn on the
    CPU from ``generator`` (so a seed gives the same restarts on every
    device) and moved to ``device``. With ``two_bracket`` each half of the
    restart axis gets the lattice axes. ``angle_xyz``, the Euler angles,
    is drawn last, so the other parameters of a seed do not depend on
    it."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    v_c = normal(batch, kernel, 3)
    if lattice_init:
        lattice = torch.tensor(
            [(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1)
             for z in (-1, 0, 1) if (x, y, z) != (0, 0, 0)],
            dtype=torch.float32,
        )
        starts = (0, kernel // 2) if two_bracket else (0,)
        n_lat = min(26, kernel // len(starts))
        for start in starts:
            v_c[:, start:start + n_lat] = lattice[:n_lat]
    params = {
        "v_c": v_c,
        "angle_c": normal(batch, kernel, 1),
        "tran_c": normal(batch, kernel, 3),
        "tran_s": normal(batch, kernel, 1),
        "angle_xyz": normal(batch, kernel, 3),
    }
    return {k: v.to(device) for k, v in params.items()}


def reparametrize(params: dict, angle_base: float, tran_mode: str = "mvp",
                  reparam: str = "sine", rotation_mode: str = "axis_angle",
                  two_bracket: bool = False):
    """Unconstrained params -> (R (B, K, 3, 3), T (B, K, 3)).

    reparam 'sine': angle = sin(angle_c·π)·π/8 + π/8 + base·π/4, tran_s =
    sin(tran_s·π) (·0.125 + 0.125 with tran_mode 'bounded'); 'sigmoid':
    angle = sigmoid·2π, tran_s = tanh·0.25; 'v3': angle = sigmoid·π/4 +
    base·π/4, tran_s = sigmoid·0.20; 'unconstrained': both raw. R is the
    rotation of ``angle`` about ``v_c``, or with rotation_mode 'euler'
    Rx·Ry·Rz of ``angle_xyz``. two_bracket puts the second half of the
    restart axis one window up."""
    if two_bracket:
        kernel = params["angle_c"].shape[1]
        bracket = (torch.arange(kernel, device=params["angle_c"].device)
                   >= kernel // 2).to(torch.float32)[None, :, None]
        angle_base = angle_base + bracket
    angle_c, scale_c = params["angle_c"], params["tran_s"]
    if reparam == "sine":
        angle = (torch.sin(angle_c * _PI) * (_PI / 8) + _PI / 8
                 + angle_base * (_PI / 4))
        tran_s = torch.sin(scale_c * _PI)
        if tran_mode == "bounded":
            tran_s = tran_s * 0.125 + 0.125
    elif reparam == "sigmoid":
        angle = torch.sigmoid(angle_c) * 2 * _PI
        tran_s = torch.tanh(scale_c) * 0.25
    elif reparam == "v3":
        angle = torch.sigmoid(angle_c) * (_PI / 4) + angle_base * (_PI / 4)
        tran_s = torch.sigmoid(scale_c) * 0.20
    elif reparam == "unconstrained":
        angle, tran_s = angle_c, scale_c
    else:
        raise ValueError(f"unknown reparam {reparam!r}")
    if rotation_mode == "euler":
        r = rotation_xyz(params["angle_xyz"])
    else:
        r = rodrigues(angle[..., 0], params["v_c"])
    t = normalize_translation(params["tran_c"], tran_s)
    return r, t


def _transform(params: dict, angle_base: float, cfg: "HOUVConfig"):
    """``reparametrize`` as ``cfg`` sets it."""
    return reparametrize(params, angle_base, cfg.tran_mode, cfg.reparam,
                         cfg.rotation_mode, cfg.two_bracket)


def _apply(src: torch.Tensor, r: torch.Tensor, t: torch.Tensor):
    """src (B, N, 3) × (B, K, 3, 3)/(B, K, 3) -> (B, K, N, 3)."""
    return torch.einsum("bnc,bkdc->bknd", src, r) + t[:, :, None, :]


def _trunc_mean_sqrt(d: torch.Tensor, k: int, fast: bool) -> torch.Tensor:
    if k >= d.shape[-1]:
        return _safe_sqrt(d).mean(-1)
    if fast:
        return smallest_k_sqrt_mean_fast(d, k)
    return _safe_sqrt(_smallest_k(d, k)).mean(-1)


def _pair_matches(src, tgt, src_t, r=None, t=None, select=False,
                  dim_mask=None):
    """One nearest-neighbour pass -> matched rows, without gradients:
    tg (B, K, N, 3), the matched tgt row per src point, and s_sel
    (B, K, M, 3), the matched RAW src row per tgt point. Direction as in
    cd(gt=tgt, out=src_t): i1 is per tgt point, i2 per src point. Shared
    query layout: tgt (B, M, 3) serves the K restarts of its pair. With
    ``dim_mask`` (a view term, ``_view_mask``) both clouds are projected
    before the search and tg comes from the projected tgt; ``select`` is
    then not taken, as in the JAX package, whose select path takes no mask.

    ``select``: the search returns coordinates (``nn_select``): tg is its
    per-src output, and the matched raw src rows are the matched transformed
    ones taken back through (r, t): s_sel = R^T (c1 - t), equal to gathering
    raw src rows up to that product's rounding."""
    bsz, kernel, n = src_t.shape[:3]
    m = tgt.shape[1]
    if dim_mask is not None:
        tgt, src_t, select = tgt * dim_mask, src_t * dim_mask, False
    if select:
        c1, c2 = nn_select(tgt, src_t.reshape(bsz * kernel, n, 3),
                           device=src.device)
        tg = c2.reshape(bsz, kernel, n, 3)
        sel_t = c1.reshape(bsz, kernel, m, 3)
        s_sel = torch.einsum("bkmd,bkdc->bkmc", sel_t - t[:, :, None, :], r)
        return tg, s_sel
    i1, i2 = chamfer_indices(tgt, src_t.reshape(bsz * kernel, n, 3),
                             device=src.device)
    tg = gather_rows(tgt, i2.reshape(bsz, kernel * n)).reshape(
        bsz, kernel, n, 3)
    s_sel = gather_rows(src, i1.reshape(bsz, kernel * m)).reshape(
        bsz, kernel, m, 3)
    return tg, s_sel


def _dists_from_matches(tgt, src_t, tg, s_sel, r, t, dim_mask=None):
    """(d1 (B·K, M), d2 (B·K, N)) squared distances from matched rows,
    differentiable through (R, T) by einsum transposes only. With
    ``dim_mask`` (a view term: tgt, src_t and tg projected) the matched raw
    src rows are projected once re-transformed."""
    bsz, kernel, n = src_t.shape[:3]
    m = tgt.shape[1]
    d2 = ((src_t - tg) ** 2).sum(-1).reshape(bsz * kernel, n)
    matched_t = torch.einsum("bkmc,bkdc->bkmd", s_sel, r) + t[:, :, None, :]
    if dim_mask is not None:
        matched_t = matched_t * dim_mask
    d1 = ((tgt[:, None] - matched_t) ** 2).sum(-1).reshape(bsz * kernel, m)
    return d1, d2


def _view_mask(dim: int, like: torch.Tensor) -> torch.Tensor:
    """(3,) ones with a 0 at ``dim``: the projection of a view term."""
    mask = torch.ones(3, dtype=like.dtype, device=like.device)
    mask[dim] = 0.0
    return mask


def _objective_matches(params, src, tgt, angle_base, cfg: HOUVConfig):
    """The match half of the objective at the current (R, T): the matched
    rows (tg, s_sel) of one search, and with ``use_view_loss`` or the
    'multi_percent' objective those of the three projected searches (else
    an empty tuple)."""
    with torch.no_grad():
        r, t = _transform(params, angle_base, cfg)
        src_t = _apply(src, r, t)
        tg, s_sel = _pair_matches(src, tgt, src_t, r, t, select=cfg.nn_select)
        views = ()
        if cfg.use_view_loss or cfg.objective == "multi_percent":
            views = tuple(
                _pair_matches(src, tgt, src_t, dim_mask=_view_mask(d, src))
                for d in range(3))
        return tg, s_sel, views


def _gathered_view_min(src, tgt, src_t, r, t, view_matches, dim, fast):
    """min(vp, vt) of the axis-``dim`` projected CD (``loss_view``) rebuilt
    from the projected search's matched rows. As in ``calc_cd_percent`` at
    percent 1.0, k is the SOURCE count and truncates both sides: with
    N != M the per-target side keeps its smallest N of M distances."""
    mask = _view_mask(dim, src)
    tg_v, s_sel_v = view_matches
    d1v, d2v = _dists_from_matches(tgt * mask, src_t * mask, tg_v, s_sel_v,
                                   r, t, mask)
    k = src.shape[1]
    return torch.minimum(_trunc_mean_sqrt(d1v, k, fast),
                         _trunc_mean_sqrt(d2v, k, fast))


def _replica_mean(loss: torch.Tensor, divisor: int | None) -> torch.Tensor:
    """The mean of the replicas' losses; with ``divisor``, their sum over
    it: a rank's share of the mean over a batch sharded across ranks (the
    gradient of each replica is then the whole batch's, bit for bit)."""
    return loss.mean() if divisor is None else loss.sum() / divisor


def _objective_cached(params, matches, src, tgt, angle_base,
                      cfg: HOUVConfig, divisor: int | None = None):
    """Mean loss over all replicas (``_replica_mean``) and the per-replica
    selection metric (B, K), rebuilt against cached matches
    (``_objective_matches``): min_1, or the min-CD at ``select_percent``,
    or for 'multi_percent' the 10% min-CD."""
    tg, s_sel, views = matches
    r, t = _transform(params, angle_base, cfg)
    bsz, kernel = r.shape[:2]
    n = src.shape[1]
    src_t = _apply(src, r, t)
    d1, d2 = _dists_from_matches(tgt, src_t, tg, s_sel, r, t)

    def min_cd(pct):
        # k from the OUTPUT (src) count for both sides, like calc_cd_percent
        k = int(n * pct)
        return torch.minimum(_trunc_mean_sqrt(d1, k, cfg.fast_trim),
                             _trunc_mean_sqrt(d2, k, cfg.fast_trim))

    def view_mins():
        return (_gathered_view_min(src, tgt, src_t, r, t, view_matches, dim,
                                   cfg.fast_trim)
                for dim, view_matches in enumerate(views))

    if cfg.objective == "multi_percent":
        # each extra term contributes a fixed multiple of the full CD's
        # magnitude (a detached ratio) with its own gradient direction
        mins = {pct: min_cd(pct) for pct in (1.0, 0.3, 0.1)}
        min1 = loss = mins[1.0]
        terms = [(mins[0.3], 8.0), (mins[0.1], 24.0)]
        terms += [(mv, 2.0) for mv in view_mins()]
        for term, w in terms:
            ratio = (min1 / torch.clamp_min(term, 1e-12)).detach()
            loss = loss + ratio * w * term
        return _replica_mean(loss, divisor), mins[0.1].reshape(bsz, kernel)
    min_1 = min_cd(cfg.percent)
    loss = cfg.loss_weight * min_1
    for mv in view_mins():
        loss = loss + mv
    sel = min_1 if cfg.select_percent is None else min_cd(cfg.select_percent)
    return _replica_mean(loss, divisor), sel.reshape(bsz, kernel)


def _objective_gather(params, src, tgt, angle_base, cfg: HOUVConfig,
                      divisor: int | None = None):
    """The objective with matches at the current parameters (reference
    semantics: the argmin is piecewise-constant in (R, T))."""
    matches = _objective_matches(params, src, tgt, angle_base, cfg)
    return _objective_cached(params, matches, src, tgt, angle_base, cfg,
                             divisor)


def _objective_scatter(params, src, tgt, angle_base, cfg: HOUVConfig,
                       divisor: int | None = None):
    """The objective through the chamfer op's own gradient: the truncated
    CD of the transformed cloud against its pair's target, per replica, and
    with ``use_view_loss`` the three projected CDs. 'multi_percent' and
    ``select_percent`` are refused, as in the JAX package."""
    if cfg.objective == "multi_percent":
        raise NotImplementedError(
            "objective='multi_percent' requires grad_mode='gather'")
    if cfg.select_percent is not None:
        raise NotImplementedError(
            "select_percent requires grad_mode='gather' (the scatter path "
            "has no spare NN pass to rank with)")
    r, t = _transform(params, angle_base, cfg)
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
    return _replica_mean(loss, divisor), min_1.reshape(bsz, kernel)


def _objective(params, src, tgt, angle_base, cfg: HOUVConfig,
               divisor: int | None = None):
    """Mean loss over all replicas (``_replica_mean``) and per-replica
    min_1 (B, K), matches taken at the current parameters."""
    if cfg.grad_mode == "gather":
        return _objective_gather(params, src, tgt, angle_base, cfg, divisor)
    return _objective_scatter(params, src, tgt, angle_base, cfg, divisor)


_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _adam_init(params: dict) -> dict:
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def _adam_update(params: dict, grads: dict, state: dict, lr: float):
    """One ``optax.adam(lr)`` step: bias-corrected moments, eps outside the
    sqrt. Returns the new params; updates ``state`` in place. A parameter
    whose gradient is None (the objective does not read it) keeps its
    value and moments, which is optax's step on a zero gradient."""
    state["count"] += 1
    bc1 = 1.0 - _B1 ** state["count"]
    bc2 = 1.0 - _B2 ** state["count"]
    out = {}
    for name, p in params.items():
        g = grads[name]
        if g is None:
            out[name] = p
            continue
        mu = (1 - _B1) * g + _B1 * state["mu"][name]
        nu = (1 - _B2) * (g * g) + _B2 * state["nu"][name]
        state["mu"][name], state["nu"][name] = mu, nu
        out[name] = p + -lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + _EPS))
    return out


def _adam_loop(src, tgt, angle_base, cfg: HOUVConfig, params: dict,
               opt_state: dict, n_steps: int, divisor: int | None = None):
    """``n_steps`` Adam steps over all replicas, matches recomputed once per
    block of ``cfg.nn_refresh`` steps (every step at refresh 1); the loss
    is ``_replica_mean``'s. Returns (params, opt_state, losses (n_steps,)),
    each loss taken before its step's update."""
    refresh = max(cfg.nn_refresh, 1)
    if n_steps % refresh:
        raise ValueError(
            f"step count {n_steps} not divisible by nn_refresh {refresh}")
    losses = []
    if refresh > 1 and (cfg.grad_mode != "gather" or cfg.use_view_loss
                        or cfg.objective != "trunc"
                        or cfg.select_percent is not None):
        raise NotImplementedError(
            "nn_refresh > 1 supports the canonical objective only "
            "(grad_mode='gather', objective='trunc', use_view_loss=False, "
            "select_percent=None)")
    if cfg.grad_mode != "gather":
        for _ in range(n_steps):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            loss, _ = _objective_scatter(leaves, src, tgt, angle_base, cfg,
                                         divisor)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
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
                                        angle_base, cfg, divisor)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
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


def _best_restart(min_1: torch.Tensor, cfg: HOUVConfig | None = None):
    """(best value (B,), best index (B,)) over the restart axis, the first
    on ties. With ``cfg.two_bracket`` the halves are brackets: bracket 0's
    best wins unless bracket 1's is below it by ``bracket_preference``."""
    if cfg is None or not cfg.two_bracket:
        idx = min_1.argmin(1)
        return min_1.gather(1, idx[:, None])[:, 0], idx
    h = min_1.shape[1] // 2
    v0, i0 = _best_restart(min_1[:, :h])
    v1, i1 = _best_restart(min_1[:, h:])
    use0 = v0 < v1 * cfg.bracket_preference
    return torch.where(use0, v0, v1), torch.where(use0, i0, i1 + h)


def _restart_agreement(min_1: torch.Tensor, r: torch.Tensor,
                       best: torch.Tensor, idx: torch.Tensor,
                       cfg: HOUVConfig) -> torch.Tensor:
    """(B,) f32 counts of the restarts that converged onto the window's
    best: loss within ``consensus_loss_ratio`` of the best (+1e-4) and
    rotation within ``consensus_angle`` degrees (geodesic) of the best
    restart's. min_1 (B, K), r (B, K, 3, 3), best/idx (B,)."""
    rows = torch.arange(r.shape[0], device=r.device)
    tr = torch.einsum("bkij,bij->bk", r, r[rows, idx])
    ang = torch.rad2deg(torch.arccos(torch.clamp((tr - 1.0) * 0.5,
                                                 -1.0, 1.0)))
    near_opt = min_1 <= best[:, None] * cfg.consensus_loss_ratio + 1e-4
    return ((ang < cfg.consensus_angle) & near_opt).sum(1).float()


def _consensus_merge(cand_loss: torch.Tensor, cand_agree: torch.Tensor,
                     cfg: HOUVConfig) -> torch.Tensor:
    """(B,) window indices: among the windows whose best loss is within
    ``consensus_window_ratio`` of the pair's best (+1e-4), the most agreed
    upon; the loss breaks ties of agreement (a term in (-0.5, 0]).
    cand_loss, cand_agree (B, P)."""
    gbest = cand_loss.amin(1, keepdim=True)
    valid = cand_loss <= gbest * cfg.consensus_window_ratio + 1e-4
    tie = torch.clamp(1.0 - cand_loss / (gbest + 1e-9), -1.0, 0.0) * 0.49
    score = torch.where(valid, cand_agree + tie, -math.inf)
    return score.argmax(1)


def _window_candidate(min_1: torch.Tensor, r: torch.Tensor,
                      t: torch.Tensor, cfg: HOUVConfig):
    """One angle window's candidate for the consensus merge: (loss (B,),
    agreement (B,), R (B, 3, 3), T (B, 3)) of its best restart."""
    best, idx = _best_restart(min_1, cfg)
    agree = _restart_agreement(min_1, r, best, idx, cfg)
    rows = torch.arange(r.shape[0], device=r.device)
    return best, agree, r[rows, idx], t[rows, idx]


def voxel_downsample_clouds(src: torch.Tensor, tgt: torch.Tensor,
                            cfg: HOUVConfig):
    """With ``cfg.voxel_downsample`` (a grid size G), each cloud becomes
    its voxel means over [-1, 1]³ (``ops/voxel.py:voxelize_mean``, packed
    in flat-voxel order), repeated cyclically to the cloud's N rows. One
    K4 scatter a cloud."""
    if not cfg.voxel_downsample:
        return src, tgt

    def reduce(cloud):
        vp, cnt = voxelize_mean(cloud, cfg.voxel_downsample, -1.0, 1.0)
        rows = torch.arange(vp.shape[1], device=vp.device)[None, :]
        return gather_rows(vp, rows % torch.clamp_min(cnt[:, None], 1))

    return reduce(src), reduce(tgt)


def houv_pass(src, tgt, params0: dict, angle_base: float, cfg: HOUVConfig,
              divisor: int | None = None):
    """One angle-window pass, phase by phase of the schedule; ``divisor``
    as in ``_replica_mean``. Returns (min_1 (B, K), R (B, K, 3, 3),
    T (B, K, 3)) at the final parameters."""
    params, opt_state = params0, _adam_init(params0)
    for n_steps, refresh, sub in _refresh_phases(cfg):
        cfg_r = dataclasses.replace(cfg, nn_refresh=refresh,
                                    nn_refresh_schedule=None)
        src_p, tgt_p = _phase_clouds(src, tgt, sub)
        params, opt_state, _ = _adam_loop(src_p, tgt_p, angle_base, cfg_r,
                                          params, opt_state, n_steps, divisor)
    with torch.no_grad():
        _, min_1 = _objective(params, src, tgt, angle_base, cfg)
        r, t = _transform(params, angle_base, cfg)
    return min_1, r, t


def houv_candidate_pools(src: torch.Tensor, tgt: torch.Tensor,
                         cfg: HOUVConfig = HOUVConfig(),
                         params0: dict | None = None,
                         generator: torch.Generator | None = None,
                         device: str | torch.device = "cuda",
                         divisor: int | None = None, best_reduce=None):
    """The angle-window passes of the hybrid solve, keeping every restart:
    window 0, then for the pairs past the threshold (or every pair, with
    ``retry_mode='always'``) windows 1..passes-1. src, tgt (B, N, 3) on
    ``device``; ``params0`` (from ``init_params`` or
    ``state.params_from_jax``) fixes the restarts, else they are drawn from
    ``generator`` (seed 0 when None). A sharded solve (``parallel/mesh.py``)
    passes the whole batch's replica count as ``divisor`` and, where the
    restarts are split, ``best_reduce``, which takes window 0's best (B,)
    to the best over every shard before the threshold. With
    ``cfg.voxel_downsample`` the passes run on the voxel-reduced clouds
    (``voxel_downsample_clouds``).

    Returns (pool_loss (B, W·K), pool_r (B, W·K, 3, 3), pool_t (B, W·K, 3),
    n_retry): a pair that never entered window w has +inf losses in that
    window's slots; n_retry counts the pairs that entered the retries."""
    dev = resolve_device(device)
    check_on(dev, src, tgt)
    # the small rigid-transform einsums must run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    src, tgt = voxel_downsample_clouds(src.float(), tgt.float(), cfg)
    if params0 is None:
        generator = generator or torch.Generator().manual_seed(0)
        params0 = init_params(generator, src.shape[0], cfg.kernel,
                              cfg.lattice_init, cfg.two_bracket, device=dev)

    min_1, r, t = houv_pass(src, tgt, params0, 0.0, cfg, divisor)
    best, _ = _best_restart(min_1, cfg)
    if best_reduce is not None:
        best = best_reduce(best)
    if cfg.retry_mode == "always":
        retry_mask = torch.ones_like(best, dtype=torch.bool)
    else:
        retry_mask = best > cfg.retry_threshold
    n_retry = int(retry_mask.sum())
    pools = [(min_1, r, t)]
    if n_retry:
        for base in range(1, cfg.angle_passes):
            m2, r2, t2 = houv_pass(src, tgt, params0, float(base), cfg,
                                   divisor)
            pools.append((torch.where(retry_mask[:, None], m2, math.inf),
                          r2, t2))
    return (torch.cat([p[0] for p in pools], 1),
            torch.cat([p[1] for p in pools], 1),
            torch.cat([p[2] for p in pools], 1), n_retry)


def houv_solve(src: torch.Tensor, tgt: torch.Tensor,
               cfg: HOUVConfig = HOUVConfig(), params0: dict | None = None,
               generator: torch.Generator | None = None,
               device: str | torch.device = "cuda") -> dict:
    """Full hybrid solve: ``pick_restart`` over the windows of
    ``houv_candidate_pools``. Arguments as there.

    Returns transform (B, 4, 4), rmse (B,) the best-restart loss, and
    n_retry, the number of pairs that entered the retry passes."""
    pool_loss, pool_r, pool_t, n_retry = houv_candidate_pools(
        src, tgt, cfg, params0, generator, device)
    transform, rmse = pick_restart(pool_loss, pool_r, pool_t, cfg)
    return {"transform": transform, "rmse": rmse, "n_retry": n_retry}


def pick_restart(pool_loss: torch.Tensor, pool_r: torch.Tensor,
                 pool_t: torch.Tensor, cfg: HOUVConfig):
    """Each pair's restart from its pool (B, W·K, ...), window-major, K =
    ``cfg.kernel``: (transform (B, 4, 4), its loss (B,)). Each window's best restart
    (``_best_restart``: the first of least loss, or the bracket pick with
    ``two_bracket``), then the first window of least best, which is the
    JAX solver's keep-if-better merge of the windows; with
    ``window_select='consensus'`` the window ``_consensus_merge`` picks."""
    k = cfg.kernel
    windows = range(pool_loss.shape[1] // k)
    bests, idxs = zip(*(_best_restart(pool_loss[:, w * k:(w + 1) * k], cfg)
                        for w in windows))
    best = torch.stack(bests, 1)                      # (B, W)
    idx = torch.stack(idxs, 1)
    rows = torch.arange(pool_loss.shape[0], device=pool_loss.device)
    if cfg.window_select == "consensus":
        agree = torch.stack([_restart_agreement(
            pool_loss[:, w * k:(w + 1) * k], pool_r[:, w * k:(w + 1) * k],
            best[:, w], idx[:, w], cfg) for w in windows], 1)
        win = _consensus_merge(best, agree, cfg)
    else:
        win = best.argmin(1)
    pick = win * k + idx[rows, win]
    return (rt_to_transformation(pool_r[rows, pick], pool_t[rows, pick]),
            best[rows, win])


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
