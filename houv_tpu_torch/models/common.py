"""Shared model blocks (counterpart of ``houv_tpu/models/common.py``).

Layout: features last, (B, N, C), as in the JAX package; a flax ``Dense`` is
an ``nn.Linear`` over the last axis. ``FlaxNamed`` modules record, for each
child layer, the auto-name flax gives the same layer (``Dense_3``,
``SKNResUnit_2``), so ``houv_tpu_torch.state.state_from_flax`` can carry JAX
parameters across name by name. ``get_graph_feature`` and ``EFExpansion``
build their graphs in the feature space, on the wide kNN kernel (on
coordinates, C == 3, on the coordinate kernel).

flax's normalisations are not torch's defaults: ``BatchNorm`` (ε 1e-5,
running statistics moved by 1% a train step) and ``LayerNorm`` (ε 1e-6)
take the biased variance as E[x²] − E[x]², floored at 0, and compute
(x − mean) · (rsqrt(var + ε) · scale) + bias.

``compute_dtype`` bf16 is flax's ``dtype=bf16``, cast by cast: a ``Dense``
rounds its input, kernel, product and bias to bf16 (``dense``), the
normalisations take their statistics and normalise in f32 on the bf16
input and round the result to bf16, ``PointMLP`` and ``EFExpansion``
return f32 (``to_f32``) and ``EFExpansion`` picks its neighbours in f32,
as the JAX modules do. Parameters and running statistics stay f32.

Data-parallel training (``train/harness.py`` with a mesh) sets a process
group on the model (``set_batch_group``): a train step's ``BatchNorm`` then
normalises by the statistics of the global batch, its sums all-reduced
over the ranks with a differentiable all-reduce, as the JAX package's
BatchNorm sees the global batch under jit with a sharded batch; and a
model's batch-coupled sums (``batch_sum``) run over the global batch. The
random draws of a step are the global batch's, sliced to the rank's rows
(``RowShard``, ``draw_rows``), so each row gets what it gets in one
process. ``attention`` and
``MultiHeadAttention`` are the JAX package's dense products (scores scaled
by 1/√d_k, a softmax, the weighted values), not a fused attention kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed.nn.functional as dist_nn
from torch import nn

from houv_tpu_torch.geometry.kabsch import weighted_kabsch
from houv_tpu_torch.geometry.rotations import (
    rmse_loss,
    rotation_error,
    rotation_geodesic_error,
    translation_error,
)
from houv_tpu_torch.ops.gather import gather_edge_features, gather_rows
from houv_tpu_torch.ops.grouping import ball_query, knn_indices, knn_points
from houv_tpu_torch.ops.sampling import furthest_point_sample


class FlaxNamed(nn.Module):
    """A module whose children carry their flax auto-names.

    ``child(attr, module)`` registers ``module`` under ``attr`` and names it
    ``<Class>_<i>`` in ``flax_names``, counting per class in the order the
    flax module constructs its layers (``nn.Linear`` counts as ``Dense``, a
    module with a ``flax_class`` attribute as that class)."""

    def __init__(self):
        super().__init__()
        self.flax_names: dict[str, str] = {}
        self._flax_counts: dict[str, int] = {}

    def child(self, attr: str, module: nn.Module) -> nn.Module:
        cls = getattr(module, "flax_class", None) or {
            nn.Linear: "Dense", nn.Embedding: "Embed"}.get(
            type(module), type(module).__name__)
        i = self._flax_counts.get(cls, 0)
        self._flax_counts[cls] = i + 1
        self.flax_names[f"{cls}_{i}"] = attr
        if "." not in attr:
            setattr(self, attr, module)
        return module


def lecun_normal_(w: torch.Tensor,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's lecun-normal in place, for a kernel in flax's layout: fan_in
    the product of all axes but the last, a normal truncated at ±2σ."""
    std = math.sqrt(1.0 / int(np.prod(w.shape[:-1]))) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisation, drawn from ``generator`` in module order:
    ``Dense`` kernels and the conv kernels a module names in
    ``lecun_params`` lecun-normal (a normal truncated at ±2σ, scaled to
    variance 1 / fan_in, fan_in the product of all axes but the last),
    zero biases, ``Embed`` tables normal at variance 1 / features; so that
    an untrained port has the JAX model's scale, the same on every
    device."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w / math.sqrt(m.weight.shape[-1]))
            for name in getattr(m, "lecun_params", ()):
                p = getattr(m, name)
                p.copy_(lecun_normal_(torch.empty(p.shape), generator))


def compute_dtype_of(name) -> torch.dtype | None:
    """A config's ``compute_dtype`` ('bfloat16', a torch dtype, None or
    'float32') as the torch dtype a layer rounds to; None is f32."""
    if name is None or name in ("float32", torch.float32):
        return None
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def dense(layer: nn.Linear, x: torch.Tensor,
          compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """flax ``Dense(dtype=compute_dtype)`` on ``layer``'s f32 parameters:
    the input and the kernel rounded to the dtype, their product rounded
    to it, then the bias, rounded, added in it; a result in that dtype.
    None runs the layer as it is."""
    if compute_dtype is None:
        return layer(x)
    y = torch.matmul(x.to(compute_dtype), layer.weight.to(compute_dtype).t())
    if layer.bias is not None:
        y = y + layer.bias.to(compute_dtype)
    return y


def to_f32(x: torch.Tensor, compute_dtype: torch.dtype | None) -> torch.Tensor:
    """A bf16 layer's result back in f32, where the JAX module casts it;
    without a compute dtype ``x`` as it is (f32, or f64 in the f64
    reference runs)."""
    return x if compute_dtype is None else x.float()


class RowShard:
    """A generator whose draws (``draw_rows``) are those of the global
    batch of ``count`` ranks' equal shards, sliced to shard ``index``."""

    def __init__(self, generator: torch.Generator, index: int, count: int):
        self.generator, self.index, self.count = generator, index, count


def draw_rows(sampler, shape, generator, groups: int = 1) -> torch.Tensor:
    """``sampler(shape, generator=generator)`` (``torch.rand`` or
    ``torch.randn``); from a ``RowShard``, the rank's rows of the global
    batch's draw. ``groups``: the leading axis holds that many blocks of
    the batch's rows (a doubled batch [x; y] has 2), each sliced."""
    if not isinstance(generator, RowShard):
        return sampler(shape, generator=generator)
    rows = shape[0] // groups
    full = sampler((groups, rows * generator.count, *shape[1:]),
                   generator=generator.generator)
    i = generator.index
    return full[:, i * rows:(i + 1) * rows].reshape(shape)


def batch_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """x.sum(); with a process group, the sum over every rank's ``x``
    (a differentiable all-reduce: each rank's backward adds every rank's
    gradient of the sum)."""
    total = x.sum()
    return total if group is None else dist_nn.all_reduce(total, group=group)


class _BatchGather(torch.autograd.Function):
    """The ranks' rows concatenated in rank order, bit for bit
    (``parallel.mesh.group_gather_rows``); the backward sums every rank's
    gradient of the whole and keeps this rank's rows (a reduce-scatter by
    an all-reduce, which gloo has on the card too)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        from houv_tpu_torch.parallel.mesh import group_gather_rows

        ctx.group = group
        ctx.index = dist.get_process_group_ranks(group).index(
            dist.get_rank())
        ctx.rows = x.shape[0]
        return group_gather_rows(x, group, ctx.index)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        start = ctx.index * ctx.rows
        return g[start:start + ctx.rows], None


def batch_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """x's rows; with a process group, every rank's rows in rank order (a
    differentiable gather: each rank's backward adds every rank's gradient
    of its rows)."""
    return x if group is None else _BatchGather.apply(x, group)


def set_batch_group(model: nn.Module, group) -> None:
    """Set the process group of every module of ``model`` that reads one
    (``batch_group``: BatchNorm, and models with batch-coupled sums)."""
    for m in model.modules():
        if hasattr(m, "batch_group"):
            m.batch_group = group


def flax_statistics(x: torch.Tensor, mask: torch.Tensor | None = None,
                    dims: tuple | None = None, group=None):
    """flax's (mean, variance) over ``dims`` (default every axis but the
    last): the variance biased, E[x²] − E[x]² floored at 0. ``mask``
    (broadcastable to ``x``, bool) keeps only the rows it marks; ``dims``
    is then every axis but the last. With a process group ``group`` the
    statistics are those of every rank's rows: their sums, sums of squares
    and counts all-reduced in one differentiable all-reduce."""
    if group is not None:
        return _global_statistics(x, mask, group)
    if mask is None:
        dims = tuple(range(x.dim() - 1)) if dims is None else dims
        mean = x.mean(dims)
        mean2 = (x * x).mean(dims)
    else:
        dims = tuple(range(x.dim() - 1))
        count = mask.sum()
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        mean = torch.where(mask, x, zero).sum(dims) / count
        mean2 = torch.where(mask, x * x, zero).sum(dims) / count
    return mean, torch.clamp_min(mean2 - mean * mean, 0.0)


def _global_statistics(x, mask, group):
    dims = tuple(range(x.dim() - 1))
    if mask is None:
        count = x.new_tensor(float(x[..., 0].numel()))
    else:
        x = torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
        count = mask.sum().to(x.dtype)
    c = x.shape[-1]
    sums = dist_nn.all_reduce(
        torch.cat([x.sum(dims), (x * x).sum(dims), count[None]]), group=group)
    mean = sums[:c] / sums[-1]
    mean2 = sums[c:2 * c] / sums[-1]
    return mean, torch.clamp_min(mean2 - mean * mean, 0.0)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32 when it is of a narrower float type (bf16), else as it is:
    flax's normalisations reduce and normalise in at least f32."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def flax_normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                   eps: float, weight: torch.Tensor | None,
                   bias: torch.Tensor | None) -> torch.Tensor:
    """(x − mean) · (rsqrt(var + ε) · weight) + bias, flax's order."""
    mul = torch.rsqrt(var + eps)
    if weight is not None:
        mul = mul * weight
    y = (x - mean) * mul
    return y if bias is None else y + bias


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over (..., C), unmasked: with ``train`` the
    batch's statistics over every axis but the last normalise, and the
    running ones move to 0.99 · running + 0.01 · batch (a module called
    twice in one step, on the source and then on the target, moves them
    twice, as flax does within one ``apply``); otherwise the running
    statistics normalise and nothing changes. ``use_bias`` and
    ``use_scale`` drop the offset or the scale, as flax's do. With a
    ``batch_group`` (``set_batch_group``) a train step's statistics are
    the global batch's, and every rank moves its running ones alike. With
    ``compute_dtype`` bf16 the statistics and the normalisation run in f32
    on the (bf16) input and the result is rounded to bf16, as flax's
    ``BatchNorm(dtype=bf16)``; without one the result is in at least
    f32."""

    flax_class = "BatchNorm"
    batch_group = None
    flax_leaves = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                   "var": "running_var"}
    momentum = 0.99

    def __init__(self, channels: int, eps: float = 1e-5,
                 use_bias: bool = True, use_scale: bool = True,
                 compute_dtype=None):
        super().__init__()
        self.eps = eps
        self.dt = compute_dtype_of(compute_dtype)
        self.weight = (nn.Parameter(torch.ones(channels)) if use_scale
                       else None)
        self.bias = nn.Parameter(torch.zeros(channels)) if use_bias else None
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def statistics(self, x: torch.Tensor, train: bool,
                   mask: torch.Tensor | None = None):
        """The (mean, variance) that normalise ``x``: in a train step the
        batch's (over the rows ``mask`` keeps), moving the running ones;
        otherwise the running ones."""
        if not train:
            return self.running_mean, self.running_var
        mean, var = flax_statistics(at_least_f32(x), mask,
                                    group=self.batch_group)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return mean, var

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = flax_normalize(at_least_f32(x), *self.statistics(x, train),
                           self.eps, self.weight, self.bias)
        return y if self.dt is None else y.to(self.dt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: ε 1e-6 (flax's default,
    where torch's is 1e-5), the variance E[x²] − E[x]² floored at 0; in
    f32 on a bf16 input, the result rounded to ``compute_dtype`` when one
    is given (else in at least f32), as flax's."""

    flax_leaves = {"scale": "weight", "bias": "bias"}

    def __init__(self, channels: int, eps: float = 1e-6, compute_dtype=None):
        super().__init__()
        self.eps = eps
        self.dt = compute_dtype_of(compute_dtype)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = at_least_f32(x)
        mean, var = flax_statistics(x, dims=(-1,))
        y = flax_normalize(x, mean[..., None], var[..., None], self.eps,
                           self.weight, self.bias)
        return y if self.dt is None else y.to(self.dt)


class PointMLP(FlaxNamed):
    """Per-point MLP over (B, N, C): ``Dense`` layers of ``features``
    widths, each (with ``use_bn``) followed by a ``BatchNorm``, with a ReLU
    between them and, with ``relu_last``, after the last. With
    ``compute_dtype`` bf16 its layers run in bf16 and it returns f32, as
    the JAX module."""

    def __init__(self, features, in_features: int, relu_last: bool = False,
                 use_bn: bool = False, compute_dtype=None):
        super().__init__()
        self.relu_last, self.use_bn = relu_last, use_bn
        self.dt = compute_dtype_of(compute_dtype)
        self.n = len(features)
        for i, f in enumerate(features):
            self.child(f"fc{i}", nn.Linear(in_features, f))
            if use_bn:
                self.child(f"bn{i}", BatchNorm(f, compute_dtype=self.dt))
            in_features = f

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.n):
            x = dense(getattr(self, f"fc{i}"), x, self.dt)
            if self.use_bn:
                x = getattr(self, f"bn{i}")(x, train)
            if i < self.n - 1 or self.relu_last:
                x = torch.relu(x)
        return to_f32(x, self.dt)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax`` over ``dim``. Below f32 (bf16) it rounds where
    JAX's does: exp(x − max) is rounded to the dtype before the sum
    divides it (``torch.softmax`` rounds once, at the end, and then
    differs from JAX's in most entries by a bf16 step)."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        return torch.softmax(x, dim)
    e = torch.exp(x - x.amax(dim, keepdim=True).detach())
    return e / e.sum(dim, keepdim=True)


def attention(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
              mask: torch.Tensor | None = None):
    """Scaled dot-product attention over (..., L, D): scores q·kᵀ / √d_k
    (−1e9 where ``mask`` is 0), a softmax over the keys, the weighted
    values, each in the inputs' dtype (bf16 inputs: a bf16 softmax, as
    the JAX package's). Returns (output, probabilities)."""
    scores = torch.matmul(query, key.transpose(-1, -2)) / math.sqrt(
        query.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(mask == 0, -1e9)
    p = softmax(scores, -1)
    return torch.matmul(p, value), p


class MultiHeadAttention(FlaxNamed):
    """Multi-head attention over inputs of width ``d_model``: ``Dense``
    projections of the query, key and value split into ``n_heads`` heads,
    ``attention`` per head, and an output ``Dense``. With ``compute_dtype``
    bf16 all of it runs in bf16 and the result is bf16, as the JAX
    module's."""

    def __init__(self, n_heads: int, d_model: int, compute_dtype=None):
        super().__init__()
        self.n_heads, self.d_model = n_heads, d_model
        self.dt = compute_dtype_of(compute_dtype)
        for name in ("q", "k", "v", "out"):
            self.child(name, nn.Linear(d_model, d_model))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, mask=None) -> torch.Tensor:
        b, d_k = query.shape[0], self.d_model // self.n_heads

        def split(x, layer):
            return dense(layer, x, self.dt).reshape(
                b, -1, self.n_heads, d_k).transpose(1, 2)

        out, _ = attention(split(query, self.q), split(key, self.k),
                           split(value, self.v), mask)
        return dense(self.out, out.transpose(1, 2).reshape(b, -1,
                                                           self.d_model),
                     self.dt)


def svd_head(src: torch.Tensor, tgt_corr: torch.Tensor,
             weights: torch.Tensor | None = None, stop_grad: bool = False):
    """The weighted-Procrustes head of DCP, DeepGMR and IDAM: (R, t)
    aligning src to tgt_corr (``geometry/kabsch.py:weighted_kabsch``),
    equal weights by default; ``stop_grad`` detaches its inputs (IDAM)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    if stop_grad:
        src, tgt_corr, weights = (src.detach(), tgt_corr.detach(),
                                  weights.detach())
    return weighted_kabsch(src, tgt_corr, weights)


def registration_outputs(loss, src, t_12, r, t, t_gt) -> dict:
    """The learned registration models' train and val outputs: the loss,
    the rotation error (degrees), translation error, RMSE of the moved
    source and geodesic + translation error per pair, and the transform."""
    r_gt, t_gt_vec = t_gt[:, :3, :3], t_gt[:, :3, 3]
    return {"loss": loss, "r_err": rotation_error(r, r_gt),
            "t_err": translation_error(t, t_gt_vec),
            "rmse": rmse_loss(src, t_12, t_gt),
            "rt_mse": rotation_geodesic_error(r, r_gt)
            + translation_error(t, t_gt_vec),
            "transform": t_12}


def transform_mse(t_12: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    """mean((T12 · T_gt⁻¹ − I)²)."""
    eye = torch.eye(4, dtype=t_12.dtype, device=t_12.device)
    return ((t_12 @ torch.linalg.inv(t_gt) - eye) ** 2).mean()


def max_pool_points(x: torch.Tensor) -> torch.Tensor:
    """Global feature: max over the point axis. (B, N, C) -> (B, C)."""
    return x.amax(-2)


def gen_grid(num_grid_point: int) -> torch.Tensor:
    """(num², 2) folding grid in [-0.05, 0.05]²."""
    x = np.linspace(-0.05, 0.05, num_grid_point, dtype=np.float32)
    gx, gy = np.meshgrid(x, x, indexing="ij")
    return torch.from_numpy(np.stack([gx, gy], -1).reshape(-1, 2))


def gen_1d_grid(num_grid_point: int) -> torch.Tensor:
    """(num, 1) grid in [-0.05, 0.05]."""
    return torch.from_numpy(np.linspace(
        -0.05, 0.05, num_grid_point, dtype=np.float32).reshape(-1, 1))


def gen_grid_up(up_ratio: int, grid_size: float = 0.2) -> torch.Tensor:
    """(up_ratio, 2) grid offsets for folding decoders."""
    sqrted = int(math.sqrt(up_ratio)) + 1
    num_x, num_y = 1, up_ratio
    for i in reversed(range(1, sqrted + 1)):
        if up_ratio % i == 0:
            num_x, num_y = i, up_ratio // i
            break
    gx = np.linspace(-grid_size, grid_size, num_x, dtype=np.float32)
    gy = np.linspace(-grid_size, grid_size, num_y, dtype=np.float32)
    x, y = np.meshgrid(gx, gy, indexing="ij")
    return torch.from_numpy(np.stack([x, y], -1).reshape(up_ratio, 2))


def get_edge_features(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) × (B, M, k) -> (B, M, k, C) neighbour features."""
    return gather_edge_features(x, idx)


def get_graph_feature(x: torch.Tensor, k: int = 20,
                      minus_center: bool = True) -> torch.Tensor:
    """DGCNN edge features: (B, N, C) -> (B, N, k, 2C), [center, neighbour -
    center] (or [center, neighbour]). Its kNN runs in the feature space
    (the wide kernel on CUDA tensors when C != 3) and carries no gradient."""
    idx = knn_indices(x, x, k, device=x.device)
    neighbors = get_edge_features(x, idx)
    center = x[:, :, None, :].expand_as(neighbors)
    if minus_center:
        return torch.cat([center, neighbors - center], -1)
    return torch.cat([center, neighbors], -1)


def edge_preserve_sampling(features: torch.Tensor, points: torch.Tensor,
                           num_samples: int, k: int = 10,
                           precomputed: tuple | None = None):
    """FPS + neighbourhood-max pooling.

    features (B, N, C), points (B, N, 3) ->
    (pooled (B, M, 2C), fps_idx (B, M), sampled points (B, M, 3)).
    ``precomputed``: the (p_idx, pn_idx, sampled) triple of
    ``vrcnet.saskn_geometry``."""
    if precomputed is not None:
        p_idx, pn_idx, sampled = precomputed
    else:
        p_idx = furthest_point_sample(points, num_samples,
                                      device=points.device)
        sampled = gather_rows(points, p_idx)
        pn_idx = knn_points(sampled, points, min(k, points.shape[1]))[1]
    neighbor = get_edge_features(features, pn_idx).amax(2)   # (B, M, C)
    center = gather_rows(features, p_idx)
    return torch.cat([center, neighbor], -1), p_idx, sampled


class EFExpansion(FlaxNamed):
    """Edge-aware feature expansion, upsampling by ``step_ratio``:
    (B, N, input_size) -> (B, N·step_ratio, output_size). Each point's k
    nearest neighbours in the feature space give k edge features; two Dense
    layers widen them to ``step_ratio`` groups of ``output_size`` channels,
    each group becomes a new point, and the new point keeps the maximum
    over its k edges. With ``compute_dtype`` bf16 the neighbours are picked
    on the input in f32, the edges and layers run in bf16 and the result
    is f32, as in the JAX module."""

    def __init__(self, input_size: int, output_size: int = 64,
                 step_ratio: int = 2, k: int = 4, compute_dtype=None):
        super().__init__()
        self.output_size, self.step_ratio, self.k = output_size, step_ratio, k
        self.dt = compute_dtype_of(compute_dtype)
        self.child("fc1", nn.Linear(2 * input_size, output_size))
        self.child("fc2", nn.Linear(2 * input_size + output_size,
                                    output_size * step_ratio))
        self.child("fc3", nn.Linear(output_size, output_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        dt = self.dt
        edge = get_graph_feature(to_f32(x, dt), self.k, minus_center=False)
        if dt is not None:
            edge = edge.to(dt)
        ef = torch.relu(torch.cat([dense(self.fc1, edge, dt), edge], -1))
        ef = torch.relu(dense(self.fc2, ef, dt))
        # (B, N, k, C_out·r) -> (B, N·r, k, C_out)
        ef = ef.reshape(b, n, self.k, self.step_ratio, self.output_size)
        ef = ef.transpose(2, 3).reshape(b, n * self.step_ratio, self.k,
                                        self.output_size)
        return to_f32(dense(self.fc3, ef, dt).amax(2), dt)


def symmetric_sample(points: torch.Tensor, num: int) -> torch.Tensor:
    """FPS, then the picks beside their mirror images in z:
    (B, N, 3) -> (B, 2·num, 3)."""
    fps = gather_rows(points, furthest_point_sample(points, num,
                                                    device=points.device))
    return torch.cat([fps, fps * fps.new_tensor([1.0, 1.0, -1.0])], 1)


def get_repulsion_loss(pred: torch.Tensor, nsample: int = 20,
                       radius: float = 0.07, h: float = 0.03) -> torch.Tensor:
    """Repulsion loss over each point's 4 nearest neighbours (self
    excluded)."""
    d2 = -knn_points(pred, pred, nsample)[0][..., 1:5]
    d2 = torch.clamp_min(d2, 1e-12)
    weight = torch.exp(-d2 / (h * h))
    return (radius - torch.sqrt(d2) * weight).mean()


def get_uniform_loss(pcd: torch.Tensor,
                     percentages=(0.004, 0.006, 0.008, 0.010, 0.012),
                     radius: float = 1.0) -> torch.Tensor:
    """Uniformity loss over FPS-seeded ball neighbourhoods: in each ball,
    every point's distance to its nearest other point against the spacing
    a uniform disk of that many points would have. (B, N, 3) -> scalar."""
    b, n, _ = pcd.shape
    npoint = max(int(n * 0.05), 1)
    loss = 0.0
    for p in percentages:
        nsample = max(int(n * p), 2)
        r = math.sqrt(p * radius)
        expect_len = math.sqrt(math.pi * radius ** 2 * p / nsample)
        seed_idx = furthest_point_sample(pcd, npoint, device=pcd.device)
        idx = ball_query(0.0, r, nsample, pcd, gather_rows(pcd, seed_idx))
        grouped = gather_rows(pcd, idx.reshape(b, -1)).reshape(
            b * npoint, nsample, 3)
        d2 = -knn_points(grouped, grouped, 2)[0][..., 1:]  # nearest non-self
        dist = torch.sqrt(d2.abs() + 1e-8).mean(-1)
        term = ((dist - expect_len) ** 2 / (expect_len + 1e-8)).mean()
        loss = loss + term * (p * 100) ** 2
    return loss / len(percentages)
