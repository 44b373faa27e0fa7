"""Trainers of the auxiliary models (counterpart of
``houv_tpu/train/aux.py``):

- ``EmbeddingTrainer``: the instance embedding (``model_embedding``) on
  triplets of partial scans, its loss the margin triplet loss on the three
  embeddings plus the anchors' class cross-entropy; validation meters
  ``acc`` (the positive nearer than the negative) and ``cls_acc``;
- ``AlignmentTrainer``: the alignment classifier (``alignment_spconv``) on
  true and false candidate transforms of each pair, binary cross-entropy
  with its BatchNorms in train mode; validation meter ``acc``;
- ``VoxelOccupancyTrainer``: the voxel-occupancy net (``voxel_asym``), its
  loss the cross-entropy of each valid voxel's occupancy in the complete
  cloud plus the squared error of its position where it is occupied;
  validation meters ``ce``, ``pos_mse`` and ``iou``.

Each adapts its split through a dataset view (``wrap_dataset``, which
``fit`` calls on both splits) and writes ``best_acc_network.ckpt`` or
``best_iou_network.ckpt`` when its tracked meter rises. ``validate`` draws
its batches' randomness (the triplets' partners, the candidate transforms)
from a generator seeded by the trainer's seed, so that two validations of
one model give the same meters (the JAX package draws them unseeded).

Data-parallel over a mesh, as ``train/harness.py`` says: a view's draws
(the triplets' partners, the candidate transforms) are made for the
global batch, which every rank builds, and each rank takes its rows; the
occupancy loss's and meters' ratios of sums run over the global batch.

The occupancy targets (``_voxel_targets``) count and sum each voxel's
complete-cloud points through K4 (``ops/scatter.py:scatter_add``), which
adds each row in ascending point order: the same targets on the card and
on the CPU, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from houv_tpu_torch.data.mvp import random_pose_np
from houv_tpu_torch.data.pipeline import batch_iterator
from houv_tpu_torch.models.alignment import (alignment_bce_loss,
                                             make_aligned_pairs)
from houv_tpu_torch.models.common import batch_sum
from houv_tpu_torch.models.embedding import triplet_loss
from houv_tpu_torch.ops.scatter import scatter_add
from houv_tpu_torch.train.harness import _Trainer
from houv_tpu_torch.utils.meters import AverageValueMeter


# ---------------------------------------------------------------------------
# dataset views
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TripletView:
    """``get_batch`` -> the completion split's ``get_triplet_batch``."""

    ds: object

    def __len__(self):
        return len(self.ds)

    def get_batch(self, indices, rng=None):
        return self.ds.get_triplet_batch(indices, rng=rng)


@dataclasses.dataclass
class AlignedPairView:
    """Registration batches -> the classifier's rows (reference
    MVP_RG_Aligned, registration/dataset.py:481-639): for each pair a true
    and a false candidate (``make_aligned_pairs`` of its transform, the
    identity in a split without one), the source moved by each
    (src @ R.T + t), the target repeated; labels 1, 0."""

    ds: object

    def __len__(self):
        return len(self.ds)

    def get_batch(self, indices, rng=None):
        rng = rng or np.random.default_rng()
        batch = self.ds.get_batch(indices, rng=rng)
        src, tgt = batch["src"], batch["tgt"]
        transform = batch.get("transform")
        if transform is None:
            transform = np.broadcast_to(np.eye(4, dtype=np.float32),
                                        (len(src), 4, 4))
        moved = np.empty((2 * len(src),) + src.shape[1:], np.float32)
        for i in range(len(src)):
            t_true, t_false = make_aligned_pairs(rng, transform[i])
            moved[2 * i] = src[i] @ t_true[:3, :3].T + t_true[:3, 3]
            moved[2 * i + 1] = src[i] @ t_false[:3, :3].T + t_false[:3, 3]
        return {"src_moved": moved,
                "tgt": np.repeat(tgt, 2, axis=0).astype(np.float32),
                "lbl": np.tile(np.array([1.0, 0.0], np.float32), len(src))}


class PoolCandidateDataset(AlignedPairView):
    """Rows of the classifier made beforehand from solver candidate pools
    (``scripts/make_rescore_dataset.py``: rotation-NMS'd chamfer optima
    labelled by their ground-truth rotation error), the rescorer's real
    inputs. ``source``: an ``.npz`` path or a dict of ``src_moved``,
    ``tgt``, ``lbl``. ``balance`` repeats the positives up to the
    negatives' count; the order is a permutation seeded by ``seed``.
    ``augment`` rotates each row's two clouds jointly by a random rotation
    (``random_pose_np(rng, π, 0)``), which keeps its label. A subclass of
    ``AlignedPairView`` so that ``AlignmentTrainer`` takes it as it is."""

    def __init__(self, source, balance: bool = True, seed: int = 0,
                 augment: bool = False):
        if isinstance(source, str):
            z = np.load(source)
            source = {k: z[k] for k in ("src_moved", "tgt", "lbl") if k in z}
        self.rows = {k: np.asarray(v) for k, v in source.items()}
        self.augment = augment
        lbl = self.rows["lbl"]
        idx = np.arange(len(lbl))
        if balance:
            pos, neg = idx[lbl > 0.5], idx[lbl <= 0.5]
            if len(pos) and len(neg) > len(pos):
                idx = np.concatenate(
                    [neg] + [pos] * int(round(len(neg) / len(pos))))
        self._index = np.random.default_rng(seed).permutation(idx)

    def __len__(self):
        return len(self._index)

    def get_batch(self, indices, rng=None):
        rows = self._index[np.asarray(indices) % len(self._index)]
        batch = {k: v[rows] for k, v in self.rows.items()}
        if self.augment:
            rng = rng or np.random.default_rng()
            for i in range(len(rows)):
                r = random_pose_np(rng, np.pi, 0.0)[:3, :3].astype(np.float32)
                batch["src_moved"][i] = batch["src_moved"][i] @ r.T
                batch["tgt"][i] = batch["tgt"][i] @ r.T
        return batch


@dataclasses.dataclass
class VoxelTargetView:
    """Completion batches with each point's voxel indices for the partial
    (``coords``, where the split does not give them) and the complete
    cloud (``gt_coords``), the split's ``_voxel_coords`` grid."""

    ds: object

    def __len__(self):
        return len(self.ds)

    def get_batch(self, indices, rng=None):
        batch = self.ds.get_batch(indices, rng=rng)
        if "coords" not in batch:
            batch["coords"] = self.ds._voxel_coords(batch["partial"])
        if "gt" in batch:
            batch["gt_coords"] = self.ds._voxel_coords(batch["gt"])
        return batch


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------

class _AuxTrainer(_Trainer):
    """What the aux trainers share: the dataset view and ``validate``. A
    trainer gives its view (``_view``), its meters (``_meters``; the one it
    keeps the best of in ``_metrics``), ``_train_loss`` and
    ``_batch_metrics``, one batch's meters."""

    _view: type = None
    _meters: tuple = ()

    def wrap_dataset(self, ds):
        return ds if isinstance(ds, self._view) else self._view(ds)

    def validate(self, val_ds, epoch: int = 0) -> dict:
        """Each meter's mean over the full batches of ``val_ds`` (wrapped
        in the trainer's view), their randomness seeded by the trainer's
        seed; a tracked meter that rose writes
        ``best_<meter>_network.ckpt``."""
        bs = self.cfg.batch_size
        width = self.mesh.size
        meters = {m: AverageValueMeter() for m in self._meters}
        n_batches = 0
        for batch in batch_iterator(self.wrap_dataset(val_ds), bs,
                                    drop_last=True, seed=self.seed):
            with torch.inference_mode():
                out = self._batch_metrics(self._local(batch))
            for m, meter in meters.items():
                meter.update(float(out[m]), bs // width)
            n_batches += 1
        self._reduce_meters(meters.values())
        self._keep_best(meters, epoch, n_batches)
        return {m: v.avg for m, v in meters.items()}


class EmbeddingTrainer(_AuxTrainer):
    """``InstanceEmbedding`` on triplet batches."""

    _view = TripletView
    _meters = ("acc", "cls_acc")
    _metrics = ("acc",)
    _higher = frozenset({"acc"})

    def _embed(self, batch):
        return [self.model(self._tensor(batch, k))
                for k in ("anchor", "positive", "negative")]

    def _train_loss(self, batch: dict, epoch: int, step: int):
        (emb_a, logits), (emb_p, _), (emb_n, _) = self._embed(batch)
        ce = F.cross_entropy(logits, self._tensor(batch, "label").long())
        return triplet_loss(emb_a, emb_p, emb_n) + ce

    def _batch_metrics(self, batch: dict) -> dict:
        (emb_a, logits), (emb_p, _), (emb_n, _) = self._embed(batch)
        d_pos = ((emb_a - emb_p) ** 2).sum(-1)
        d_neg = ((emb_a - emb_n) ** 2).sum(-1)
        label = self._tensor(batch, "label").long()
        return {"acc": (d_pos < d_neg).float().mean(),
                "cls_acc": (logits.argmax(-1) == label).float().mean()}


class AlignmentTrainer(_AuxTrainer):
    """``AlignmentClassifier`` on true and false candidate pairs. An
    ``override_gate`` set on the trainer (a function of the model and the
    epoch) runs after each validation: a training script's second
    selection of checkpoints, on the deployed rescoring rule."""

    _view = AlignedPairView
    _meters = ("acc",)
    _metrics = ("acc",)
    _higher = frozenset({"acc"})
    override_gate = None

    def _logits(self, batch: dict, train: bool):
        extra = self._tensor(batch, "extra") if "extra" in batch else None
        return self.model(self._tensor(batch, "src_moved"),
                          self._tensor(batch, "tgt"), extra, train=train)

    def _train_loss(self, batch: dict, epoch: int, step: int):
        return alignment_bce_loss(self._logits(batch, True),
                                  self._tensor(batch, "lbl"))

    def _batch_metrics(self, batch: dict) -> dict:
        pred = (self._logits(batch, False) > 0).float()
        return {"acc": (pred == self._tensor(batch, "lbl")).float().mean()}

    def validate(self, val_ds, epoch: int = 0) -> dict:
        out = super().validate(val_ds, epoch)
        if self.override_gate is not None:
            self.override_gate(self.model, epoch)
        return out


def _voxel_targets(gt: torch.Tensor, gt_coords: torch.Tensor,
                   grid_size: int):
    """Each voxel's targets from the complete cloud (reference getGt,
    completion/utils_loss.py:6-38): occupancy (B, G³), 1 where a point of
    ``gt`` (B, N, 3) falls in the voxel, and the mean of those points
    (B, G³, 3), 0 where none does. ``gt_coords`` (B, N, 3) are the points'
    voxel indices. One K4 scatter of [1, x, y, z] onto the G³ voxels gives
    the counts and the sums, each added in ascending point order."""
    g = grid_size
    flat = (gt_coords[..., 0].long() * g + gt_coords[..., 1]) * g \
        + gt_coords[..., 2]
    vals = torch.cat([torch.ones_like(gt[..., :1]), gt], -1)
    sums = scatter_add(flat, vals, g ** 3, device=gt.device)
    cnt = sums[..., 0]
    return (cnt > 0).float(), sums[..., 1:] / cnt.clamp_min(1.0)[..., None]


class VoxelOccupancyTrainer(_AuxTrainer):
    """``VoxAsym`` on completion batches with voxel indices."""

    _view = VoxelTargetView
    _meters = ("ce", "pos_mse", "iou")
    _metrics = ("iou",)
    _higher = frozenset({"iou"})

    def _vox_loss(self, batch: dict, train: bool):
        """(loss, meters) of one batch: the masked occupancy CE plus the
        position MSE over the occupied valid voxels; the IoU of the
        predicted occupancy (probability > 0.5) over the valid voxels.
        Each sum is the global batch's (``batch_sum`` over the mesh), so
        every rank's loss and meters are the global batch's."""
        g = self.model.grid_size
        group = self.mesh.group()

        def total(x):
            return batch_sum(x, group)

        probs, pos, vox_coords, mask = self.model(
            self._tensor(batch, "partial"),
            self._tensor(batch, "coords").long(), train)
        occ_grid, pos_grid = _voxel_targets(
            self._tensor(batch, "gt"), self._tensor(batch, "gt_coords"), g)
        flat = (vox_coords[..., 0] * g + vox_coords[..., 1]) * g \
            + vox_coords[..., 2]
        occ_t = occ_grid.gather(1, flat)                          # (B, V)
        pos_t = pos_grid.gather(1, flat[..., None].expand(-1, -1, 3))
        m = mask.float()
        logp = torch.log(probs.clamp_min(1e-9))
        ce = -(occ_t * logp[..., 1] + (1 - occ_t) * logp[..., 0])
        ce = total(ce * m) / total(m).clamp_min(1.0)
        pos_m = m * occ_t
        pos_mse = total(((pos - pos_t) ** 2).sum(-1) * pos_m) \
            / total(pos_m).clamp_min(1.0)
        pred = (probs[..., 1] > 0.5).float()
        inter = total(pred * occ_t * m)
        union = total(torch.maximum(pred, occ_t) * m)
        return ce + pos_mse, {"ce": ce, "pos_mse": pos_mse,
                              "iou": inter / union.clamp_min(1.0)}

    def _train_loss(self, batch: dict, epoch: int, step: int):
        return self._vox_loss(batch, True)[0]

    def _batch_metrics(self, batch: dict) -> dict:
        return self._vox_loss(batch, False)[1]


AUX_TRAINERS = {"model_embedding": EmbeddingTrainer,
                "alignment_spconv": AlignmentTrainer,
                "voxel_asym": VoxelOccupancyTrainer}
