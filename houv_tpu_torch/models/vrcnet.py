"""VRCNet with its in-model losses (counterpart of
``houv_tpu/models/vrcnet.py``).

PCN encoder -> posterior and prior Linear_ResBlocks -> reparametrised latent
-> generator added to the global feature -> the relational decoder
``MSAPSKNDecoder``: an FC coarse cloud concatenated with the input, the
``SASKNResEncoder`` U-Net of point self-attention with selective-kernel
fusion and edge pooling / three-NN unpooling, FPS and score selection, and
optional local folding. Features last, (B, N, C).

The coordinate-only geometry (``saskn_geometry``: the FPS pyramid, the kNN
graphs, the three-NN weights) runs on the ``knn`` and ``fps`` kernels; the
``val`` metrics on ``nn_both`` (chamfer) and ``emd`` (auction EMD). The
``train`` prefix runs both paths on a doubled batch and returns the loss
10·CD(coarse_raw) + 0.5·CD(coarse_high) + CD(coarse) + α·CD(fine) +
20·(KL_rec + KL_g) (CD or EMD, KL or MMD); its chamfer terms are
differentiated through the ``scatter`` kernel. All randomness (latent noise,
dropout masks) is drawn from a ``torch.Generator`` handed in, or passed in
as tensors. ``EFExpansion`` (when the fine cloud has at least twice the
decoder's points, and as the fine stage without ``local_folding``) builds
its graph in the feature space, on the wide kNN kernel. ``compute_dtype``
bf16 runs the ``SASKNResEncoder`` and both ``EFExpansion``s in bf16, as
the JAX model does; the PCN encoder, the latent blocks, the decoder's
other layers, the geometry and the losses stay f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from houv_tpu_torch.metrics.cd import calc_cd
from houv_tpu_torch.metrics.emd import calc_emd
from houv_tpu_torch.models.common import (
    EFExpansion,
    FlaxNamed,
    batch_gather,
    compute_dtype_of,
    dense,
    draw_rows,
    edge_preserve_sampling,
    gen_grid_up,
    get_edge_features,
    to_f32,
)
from houv_tpu_torch.models.pcn import PCNEncoder
from houv_tpu_torch.ops.gather import gather_rows
from houv_tpu_torch.ops.grouping import knn_points
from houv_tpu_torch.ops.interpolate import (
    three_interpolate,
    three_nn_upsampling,
)
from houv_tpu_torch.ops.sampling import furthest_point_sample

class SAModule(FlaxNamed):
    """Point self-attention over a kNN graph: x (B, N, C), idx (B, N, k) ->
    (B, N, out_planes) f32, residual. The projections are pointwise, so they
    run before the neighbour gather, as in the JAX module. With
    ``compute_dtype`` bf16 the layers run in bf16 (``common.dense``), the
    weighted sum over the neighbours too (summed in f32, rounded), and the
    residual is added in bf16 before the f32 result."""

    def __init__(self, rel_planes: int, mid_planes: int, out_planes: int,
                 share_planes: int = 8, k: int = 16, compute_dtype=None):
        super().__init__()
        self.rel, self.mid, self.share, self.k = (
            rel_planes, mid_planes, share_planes, k)
        self.dt = compute_dtype_of(compute_dtype)
        c = out_planes
        self.child("q", nn.Linear(c, rel_planes))
        self.child("kv_rel", nn.Linear(c, rel_planes))
        self.child("kv_mid", nn.Linear(c, mid_planes))
        self.child("w1", nn.Linear(rel_planes * (k + 1),
                                   mid_planes // share_planes, bias=False))
        self.child("w2", nn.Linear(mid_planes // share_planes,
                                   k * mid_planes // share_planes))
        self.child("proj", nn.Linear(mid_planes, out_planes))

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        dt = self.dt
        h = torch.relu(x)
        x1 = dense(self.q, h, dt)
        x23 = get_edge_features(
            torch.cat([dense(self.kv_rel, h, dt), dense(self.kv_mid, h, dt)],
                      -1), idx)
        x2 = x23[..., :self.rel].reshape(b, n, self.k * self.rel)
        x3 = x23[..., self.rel:]                               # (B, N, k, mid)
        w = torch.relu(torch.cat([x1, x2], -1))
        w = torch.relu(dense(self.w1, w, dt))
        w = dense(self.w2, w, dt).reshape(b, n, self.k, self.mid // self.share)
        x3r = x3.reshape(b, n, self.k, self.share, self.mid // self.share)
        out = (w[:, :, :, None, :] * x3r).sum(2).reshape(b, n, self.mid)
        return to_f32(dense(self.proj, torch.relu(out), dt) + x, dt)


class SKSAModule(FlaxNamed):
    """Selective-kernel fusion of SA modules at different k: a softmax over
    the ks axis weights each branch per channel."""

    def __init__(self, rel_planes: int, mid_planes: int, out_planes: int,
                 share_planes: int = 8, ks: tuple = (10, 20), r: int = 2,
                 L: int = 32, compute_dtype=None):
        super().__init__()
        d = max(out_planes // r, L)
        self.dt = compute_dtype_of(compute_dtype)
        self.sa = nn.ModuleList()
        for i, k in enumerate(ks):
            self.sa.append(self.child(f"sa.{i}", SAModule(
                rel_planes, mid_planes, out_planes, share_planes, k,
                compute_dtype)))
        self.child("squeeze", nn.Linear(out_planes, d))
        self.excite = nn.ModuleList()
        for i in range(len(ks)):
            self.excite.append(self.child(f"excite.{i}",
                                          nn.Linear(d, out_planes)))

    def forward(self, x: torch.Tensor, idxs: list) -> torch.Tensor:
        dt = self.dt
        feas = torch.stack([torch.relu(sa(x, idx))
                            for sa, idx in zip(self.sa, idxs)], 1)
        fea_z = dense(self.squeeze, feas.sum(1).mean(1), dt)      # (B, d)
        att = torch.stack([dense(fc, fea_z, dt) for fc in self.excite],
                          1)                                      # (B, nk, C)
        att = torch.softmax(to_f32(att, dt), dim=1)[:, :, None, :]
        return (feas * att).sum(1)


class SKNResUnit(FlaxNamed):
    """Dense -> SK-SA blocks -> Dense, plus a Dense residual projection;
    an f32 result (summed in bf16 with ``compute_dtype`` bf16)."""

    def __init__(self, input_size: int, output_size: int,
                 ks: tuple = (10, 20), layers: int = 1, compute_dtype=None):
        super().__init__()
        c = output_size
        self.dt = compute_dtype_of(compute_dtype)
        self.child("fc_in", nn.Linear(input_size, c, bias=False))
        self.sk = nn.ModuleList()
        for i in range(layers):
            self.sk.append(self.child(f"sk.{i}", SKSAModule(
                c // 16, c // 4, c, 8, ks, compute_dtype=compute_dtype)))
        self.child("fc_out", nn.Linear(c, c, bias=False))
        self.child("shortcut", nn.Linear(input_size, c, bias=False))

    def forward(self, feat: torch.Tensor, idxs: list) -> torch.Tensor:
        dt = self.dt
        x = dense(self.fc_in, feat, dt)
        for sk in self.sk:
            x = sk(x, idxs)
        return to_f32(dense(self.fc_out, torch.relu(x), dt)
                      + dense(self.shortcut, feat, dt), dt)


def saskn_geometry(points: torch.Tensor, pts_num: tuple, ks: tuple, pk: int):
    """The coordinate-only geometry of ``SASKNResEncoder``: the FPS point
    pyramid, per-level kNN graphs, pooling neighbourhoods and three-NN
    unpooling weights. Returns {'knn': [[idx per k] per level],
    'eps': [(p_idx, pn_idx, sampled) per downsample],
    'unpool': [(idx, w) per upsample, deepest first]}."""
    pts = points
    pts_list = [pts]
    knn_lvls, eps = [], []
    for lvl in range(len(pts_num)):
        knn_lvls.append([knn_points(pts, pts, k)[1] for k in ks])
        if lvl + 1 < len(pts_num):
            p_idx = furthest_point_sample(pts, pts_num[lvl + 1],
                                          device=pts.device)
            sampled = gather_rows(pts, p_idx)
            pn_idx = knn_points(sampled, pts, min(pk, pts.shape[1]))[1]
            eps.append((p_idx, pn_idx, sampled))
            pts_list.append(sampled)
            pts = sampled
    unpool = [three_nn_upsampling(pts_list[lvl - 1], pts_list[lvl])
              for lvl in range(len(pts_num) - 1, 0, -1)]
    return {"knn": knn_lvls, "eps": eps, "unpool": unpool}


class SASKNResEncoder(FlaxNamed):
    """U-Net of SK-SA units over four point resolutions with edge pooling
    and three-NN unpooling: features (B, N, input_size), xyz in the first 3
    channels -> (B, N, output_size).

    ``dropout``: None (inference, the identity) or the two keep masks of
    ``dropout_masks`` for the bottleneck's two dropouts. ``remat``
    recomputes the SK-SA units in the backward instead of keeping their
    (B, N, k, C) maps; the geometry stays outside and is never recomputed.
    With ``compute_dtype`` bf16 the units and the bottleneck's and U-Net's
    Dense layers run in bf16, their results back in f32 where the JAX
    module casts them: after the units, the bottleneck's dropouts, ``up4``,
    ``up3``, ``up2`` and the last layer (``up1``'s stays bf16)."""

    dropout_rate = 0.5
    dropout_widths = (512, 1024)

    def __init__(self, input_size: int, ks: tuple = (10, 20), pk: int = 16,
                 output_size: int = 64, layers: tuple = (2, 2, 2, 2),
                 remat: bool = False, compute_dtype=None):
        super().__init__()
        self.ks, self.pk = tuple(ks), pk
        self.remat = remat
        self.dt = compute_dtype_of(compute_dtype)
        c1 = 64
        self.units = nn.ModuleList()
        for i, c_in in enumerate((input_size, c1 * 2, c1 * 4, c1 * 8)):
            self.units.append(self.child(f"units.{i}", SKNResUnit(
                c_in, c1 * 2**i, ks, layers[i], compute_dtype)))
        self.child("g1", nn.Linear(c1 * 8, 1024))
        self.child("g2", nn.Linear(1024, 512))
        self.child("g3", nn.Linear(512, 1024))
        self.child("up4", nn.Linear(1024 + c1 * 8, c1 * 8))
        self.child("up3", nn.Linear(c1 * 8 + c1 * 4, c1 * 4))
        self.child("up2", nn.Linear(c1 * 4 + c1 * 2, c1 * 2))
        self.child("up1", nn.Linear(c1 * 2 + c1, c1))
        self.child("out", nn.Linear(c1, output_size))

    def dropout_masks(self, batch: int, generator: torch.Generator | None,
                      groups: int = 1):
        """The two keep masks (batch, 512) and (batch, 1024), 1 = kept with
        probability 1 - ``dropout_rate``, drawn on the CPU (``draw_rows``:
        ``groups`` blocks of the batch's rows)."""
        return tuple(
            (draw_rows(torch.rand, (batch, w), generator, groups)
             >= self.dropout_rate).float() for w in self.dropout_widths)

    def forward(self, features: torch.Tensor, geo: dict | None = None,
                dropout: tuple | None = None):
        if geo is None:
            n = features.shape[1]
            geo = saskn_geometry(features[..., :3],
                                 (n, n // 2, n // 4, n // 8), self.ks, self.pk)
        unpools = iter(geo["unpool"])

        def unpool(feat):
            idx, w = next(unpools)
            return three_interpolate(feat.transpose(1, 2), idx,
                                     w).transpose(1, 2)

        skips = []
        x = features
        for lvl, unit in enumerate(self.units):
            if lvl:
                x = edge_preserve_sampling(x, None, 0,
                                           precomputed=geo["eps"][lvl - 1])[0]
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(unit, x, geo["knn"][lvl], use_reentrant=False)
            else:
                x = unit(x, geo["knn"][lvl])
            x = torch.relu(x)
            skips.append(x)
        x1, x2, x3, x4 = skips
        keep = [None, None] if dropout is None else [
            m.to(x4.device) / (1.0 - self.dropout_rate) for m in dropout]
        dt = self.dt
        g = dense(self.g1, x4, dt).amax(1)                        # (B, 1024)
        g = torch.relu(dense(self.g2, g, dt))
        if keep[0] is not None:
            g = g * keep[0].to(g.dtype)
        g = torch.relu(dense(self.g3, g, dt))
        if keep[1] is not None:
            g = g * keep[1].to(g.dtype)
        g = to_f32(g, dt)[:, None, :].expand(-1, x4.shape[1], -1)
        x = torch.relu(to_f32(dense(self.up4, torch.cat([g, x4], -1), dt),
                              dt))
        x = torch.relu(to_f32(dense(self.up3, torch.cat([unpool(x), x3], -1),
                                    dt), dt))
        x = torch.relu(to_f32(dense(self.up2, torch.cat([unpool(x), x2], -1),
                                    dt), dt))
        x = torch.relu(dense(self.up1, torch.cat([unpool(x), x1], -1), dt))
        return to_f32(dense(self.out, x, dt), dt)


class Folding(FlaxNamed):
    """Grid folding upsampler: point_feat (B, N, C) + global (B, G) ->
    (B, N·step_ratio, output_size)."""

    def __init__(self, input_size: int, output_size: int, step_ratio: int):
        super().__init__()
        self.step_ratio = step_ratio
        self.child("fc", nn.Linear(input_size + 2, output_size))

    def forward(self, point_feat: torch.Tensor,
                global_feat: torch.Tensor) -> torch.Tensor:
        b, n, _ = point_feat.shape
        r = self.step_ratio
        grid = gen_grid_up(r, 0.2).to(point_feat.device)
        pf = point_feat.repeat_interleave(r, dim=1)
        gf = global_feat[:, None, :].expand(-1, n * r, -1)
        h = torch.cat([gf, pf, grid[None].repeat(b, n, 1)], -1)
        return torch.relu(self.fc(h))


class LinearResBlock(FlaxNamed):
    """relu -> Dense -> relu -> Dense, plus a Dense residual."""

    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.child("fc1", nn.Linear(input_size, input_size))
        self.child("fc2", nn.Linear(input_size, output_size))
        self.child("shortcut", nn.Linear(input_size, output_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc2(torch.relu(self.fc1(torch.relu(x))))
        return h + self.shortcut(x)


class MSAPSKNDecoder(FlaxNamed):
    """The multi-stage relational decoder: (global feature (B, G), input
    (B, n_input, 3)) -> (coarse_raw, coarse_high, coarse, fine), each
    (B, ·, 3). Which stages exist follows from the point counts, as in the
    JAX module, so they are fixed here from ``n_input``."""

    def __init__(self, global_size: int, n_input: int, num_coarse_raw: int,
                 num_fps: int, num_coarse: int, num_fine: int,
                 layers: tuple = (2, 2, 2, 2), knn_list: tuple = (10, 20),
                 pk: int = 10, points_label: bool = False,
                 local_folding: bool = False, remat: bool = False,
                 compute_dtype=None):
        super().__init__()
        self.n_input = n_input
        self.num_coarse_raw, self.num_fps = num_coarse_raw, num_fps
        self.num_coarse, self.num_fine = num_coarse, num_fine
        self.knn_list, self.pk = tuple(knn_list), pk
        self.points_label = points_label
        up_scale = math.ceil(num_fine / (num_coarse_raw + 2048))
        n_fps = min((num_coarse_raw + n_input) * max(up_scale, 1), num_fps)
        n_coarse = min(n_fps, num_coarse)
        self.child("fc1", nn.Linear(global_size, 1024))
        self.child("fc2", nn.Linear(1024, 1024))
        self.child("fc_raw", nn.Linear(1024, num_coarse_raw * 3))
        self.child("encoder", SASKNResEncoder(
            3 + int(points_label), knn_list, pk, 256, layers, remat,
            compute_dtype))
        self.expand = None
        if up_scale >= 2:
            self.expand = self.child("expand", EFExpansion(
                256, 64, step_ratio=up_scale, k=4,
                compute_dtype=compute_dtype))
        self.child("feat", nn.Linear(64 if up_scale >= 2 else 256, 64))
        self.child("high", nn.Linear(64, 3))
        self.score = n_fps > num_coarse
        if self.score:
            self.child("score1", nn.Linear(64, 16))
            self.child("score2", nn.Linear(16, 8))
            self.child("score3", nn.Linear(8, 1))
        self.fold = n_coarse < num_fine
        self.local_folding = local_folding
        if self.fold:
            self.ratio = num_fine // num_coarse
            if local_folding:
                self.child("folding", Folding(global_size + 64, 256,
                                              self.ratio))
            else:
                self.child("folding", EFExpansion(
                    64, 256, step_ratio=self.ratio, k=4,
                    compute_dtype=compute_dtype))
            # flax builds the outer Dense(3) before the inner Dense(64)
            self.child("fine_out", nn.Linear(64, 3))
            self.child("fine_hidden", nn.Linear(256, 64))

    def forward(self, global_feat: torch.Tensor, point_input: torch.Tensor,
                dropout: tuple | None = None):
        b = global_feat.shape[0]
        if point_input.shape[1] != self.n_input:
            raise ValueError(f"built for {self.n_input} input points, got "
                             f"{point_input.shape[1]}")
        h = torch.relu(self.fc2(torch.relu(self.fc1(global_feat))))
        coarse_raw = self.fc_raw(h).reshape(b, self.num_coarse_raw, 3)
        coarse_in, input_in = coarse_raw, point_input
        if self.points_label:
            coarse_in = torch.cat([coarse_raw, coarse_raw.new_zeros(
                b, self.num_coarse_raw, 1)], -1)
            input_in = torch.cat([point_input, point_input.new_ones(
                b, self.n_input, 1)], -1)
        points = torch.cat([coarse_in, input_in], 1)
        t = points.shape[1]
        geo = saskn_geometry(points[..., :3], (t, t // 2, t // 4, t // 8),
                             self.knn_list, self.pk)
        dense_feat = self.encoder(points, geo, dropout)
        if self.expand is not None:
            dense_feat = self.expand(dense_feat)
        coarse_features = torch.relu(self.feat(dense_feat))
        coarse_high = self.high(coarse_features)

        coarse, feats = coarse_high, coarse_features
        if coarse_high.shape[1] > self.num_fps:
            idx = furthest_point_sample(coarse_high, self.num_fps,
                                        device=coarse_high.device)
            coarse, feats = gather_rows(coarse, idx), gather_rows(feats, idx)
        if self.score:
            s = torch.relu(self.score2(torch.relu(self.score1(feats))))
            scores = F.softplus(self.score3(s))[..., 0]
            # lax.top_k order: descending, ties to the smaller index
            idx = torch.sort(scores, dim=-1, descending=True,
                             stable=True).indices[:, :self.num_coarse]
            coarse, feats = gather_rows(coarse, idx), gather_rows(feats, idx)
        if not self.fold:
            return coarse_raw, coarse_high, coarse, coarse
        if self.local_folding:
            up = self.folding(feats, global_feat)
            center = coarse.repeat_interleave(self.ratio, dim=1)
            fine = self.fine_out(torch.relu(self.fine_hidden(up))) + center
        else:
            fine = self.fine_out(torch.relu(self.fine_hidden(
                self.folding(feats))))
        return coarse_raw, coarse_high, coarse, fine


def _kl_normal(mu0, std0, mu1, std1):
    """KL(N(mu0, std0) || N(mu1, std1)), elementwise."""
    v0, v1 = std0 ** 2, std1 ** 2
    return torch.log(std1 / std0) + (v0 + (mu0 - mu1) ** 2) / (2 * v1) - 0.5


def _mmd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Gaussian-kernel maximum mean discrepancy between two batches of
    latent samples (B, D): k(a, b) = exp(-mean((a - b)²) / D)."""
    def kernel(a, b):
        d = ((a[:, None, :] - b[None, :, :]) ** 2).mean(-1)
        return torch.exp(-d / a.shape[-1])

    return (kernel(x, x).mean() + kernel(y, y).mean()
            - 2.0 * kernel(x, y).mean())


class VRCNet(FlaxNamed):
    """The dual-path VRCNet: x (B, n_input, 3) -> {'result': fine}
    ('test'); with gt the metrics cd_p, cd_t, f1 per cloud, and emd when
    ``eval_emd`` ('val'); or {'out2', 'loss2', 'total_loss'} ('train', with
    ``alpha`` the weight of the fine term).

    Randomness is explicit. The latent samples are mu + std · noise:
    ``noise`` is one (B, size_z) tensor for 'val' and 'test', and for
    'train' a sequence of two (posterior, prior; four with
    ``distribution_loss='MMD'``: then the N(0, 1) sample and the detached
    prior's noise); ``dropout_masks`` are the decoder's two keep masks over
    the doubled batch (``SASKNResEncoder.dropout_masks``). Whatever is not
    passed is drawn from ``generator``, the noise first, then the masks.
    Data-parallel training sets ``batch_group``
    (``common.set_batch_group``): MMD then compares the global batch's
    samples, gathered over the group on every rank (each rank's noise the
    global draw's rows, ``RowShard``), as one process on the whole batch
    does."""

    _batch_group = None

    def __init__(self, num_points: int = 2048, num_coarse_raw: int = 1024,
                 num_fps: int = 2048, num_coarse: int = 2048,
                 size_z: int = 128, global_feature_size: int = 1024,
                 layers: tuple = (2, 2, 2, 2), knn_list: tuple = (10, 20),
                 pk: int = 10, points_label: bool = False,
                 local_folding: bool = False, eval_emd: bool = False,
                 n_input: int | None = None, remat: bool = False,
                 distribution_loss: str = "KLD", train_loss: str = "cd",
                 compute_dtype=None):
        super().__init__()
        if distribution_loss not in ("KLD", "MMD"):
            raise NotImplementedError("distribution loss is either MMD or KLD")
        if train_loss not in ("cd", "emd"):
            raise NotImplementedError("train loss is either cd or emd")
        g = global_feature_size
        self.size_z = size_z
        self.eval_emd = eval_emd
        self.distribution_loss = distribution_loss
        self.train_loss = train_loss
        self.child("encoder", PCNEncoder(g))
        self.child("post1", LinearResBlock(g, g))
        self.child("post2", LinearResBlock(g, size_z * 2))
        self.child("prior", LinearResBlock(g, size_z * 2))   # training only
        self.child("generator", LinearResBlock(size_z, g))
        self.child("decoder", MSAPSKNDecoder(
            g, num_points if n_input is None else n_input, num_coarse_raw,
            num_fps, num_coarse, num_points, layers, knn_list, pk,
            points_label, local_folding, remat, compute_dtype))

    @property
    def batch_group(self):
        """The process group of data-parallel training, or None."""
        return self._batch_group

    @batch_group.setter
    def batch_group(self, group):
        self._batch_group = group

    def _moments(self, o: torch.Tensor):
        return o[:, :self.size_z], F.softplus(o[:, self.size_z:])

    def _train(self, x, gt, alpha, noise, generator, dropout_masks):
        b, n_input = x.shape[:2]
        n_noise = 4 if self.distribution_loss == "MMD" else 2
        if noise is None:
            noise = [draw_rows(torch.randn, (b, self.size_z), generator)
                     for _ in range(n_noise)]
        if len(noise) != n_noise:
            raise ValueError(f"'train' with {self.distribution_loss} takes "
                             f"{n_noise} noise tensors, got {len(noise)}")
        noise = [t.to(x.device) for t in noise]
        if dropout_masks is None:
            dropout_masks = self.decoder.encoder.dropout_masks(
                2 * b, generator, groups=2)
        y = gather_rows(gt, furthest_point_sample(gt, n_input,
                                                  device=gt.device))
        gt2 = torch.cat([gt, gt], 0)
        feat = self.encoder(torch.cat([x, y], 0))
        feat_x, feat_y = feat[:b], feat[b:]
        q_mu, q_std = self._moments(self.post2(self.post1(feat_x)))
        p_mu, p_std = self._moments(self.prior(feat_y))
        z_q = q_mu + q_std * noise[0]
        z_p = p_mu + p_std * noise[1]
        feat = torch.cat([feat_x, feat_x], 0) + self.generator(
            torch.cat([z_q, z_p], 0))
        coarse_raw, coarse_high, coarse, fine = self.decoder(
            feat, torch.cat([x, x], 0), dropout_masks)

        if self.distribution_loss == "KLD":
            dl_rec = _kl_normal(torch.zeros_like(p_mu),
                                torch.ones_like(p_std), p_mu, p_std)
            dl_g = _kl_normal(p_mu.detach(), p_std.detach(), q_mu, q_std)
        else:
            # every rank computes the global batch's MMD: the gather's
            # backward sums the ranks' equal gradients into each rank's
            # rows, and the ranks' average of the parameters' gradients
            # then holds one process's on the whole batch
            group = self._batch_group
            z_p_fix = p_mu.detach() + p_std.detach() * noise[3]
            dl_rec = _mmd(batch_gather(noise[2], group),
                          batch_gather(z_p, group))
            dl_g = _mmd(batch_gather(z_q, group),
                        batch_gather(z_p_fix, group))
        if self.train_loss == "cd":
            loss1 = calc_cd(coarse_raw, gt2)[0]
            loss2 = calc_cd(coarse_high, gt2)[0]
            loss3 = calc_cd(coarse, gt2)[0]
            loss4, loss4_t = calc_cd(fine, gt2)
        else:
            # loss2 stays cd_t, so the logged metric matches the cd configs
            loss1 = calc_emd(coarse_raw, gt2)
            loss2 = calc_emd(coarse_high, gt2)
            loss3 = calc_emd(coarse, gt2)
            loss4 = calc_emd(fine, gt2)
            loss4_t = calc_cd(fine, gt2)[1]
        total = (loss1.mean() * 10 + loss2.mean() * 0.5 + loss3.mean()
                 + loss4.mean() * alpha
                 + (dl_rec.mean() + dl_g.mean()) * 20)
        return {"out2": fine, "loss2": loss4_t, "total_loss": total}

    def forward(self, x: torch.Tensor, gt: torch.Tensor | None = None,
                prefix: str = "test", noise=None,
                generator: torch.Generator | None = None,
                alpha: float | None = None,
                dropout_masks: tuple | None = None) -> dict:
        if prefix == "train":
            return self._train(x, gt, alpha, noise, generator, dropout_masks)
        if prefix not in ("val", "test"):
            raise ValueError(
                f"prefix is 'train', 'val' or 'test', got {prefix!r}")
        feat = self.encoder(x)
        q_mu, q_std = self._moments(self.post2(self.post1(feat)))
        if noise is None:
            noise = draw_rows(torch.randn, q_mu.shape, generator)
        z = q_mu + q_std * noise.to(q_mu.device)
        feat = feat + self.generator(z)
        coarse_raw, _, _, fine = self.decoder(feat, x)
        if prefix == "test":
            return {"result": fine}
        cd_p, cd_t, f1 = calc_cd(fine, gt, calc_f1=True)
        out = {"out1": coarse_raw, "out2": fine, "cd_p": cd_p, "cd_t": cd_t,
               "f1": f1}
        if self.eval_emd:
            out["emd"] = calc_emd(fine, gt, eps=0.004, iterations=3000)
        return out
