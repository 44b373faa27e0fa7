"""MVP data: pose synthesis, synthetic fixtures, h5 loading, datasets.

Counterpart of ``houv_tpu/data/mvp.py`` (registration half, and the
completion half without voxels), in plain numpy. The synthetic generators
are copies of the JAX package's, so the same seed gives byte-identical
arrays in both packages.

MVP_RG h5 keys: src, tgt, rotated_src, rotated_tgt, transforms, pose_src,
pose_tgt, complete, cat_labels, match_id (group of ragged int arrays),
match_level, rot_level. Train-time pose synthesis: transform =
random_pose(max_angle, max_trans/2), pose1 = random_pose(pi, max_trans),
pose2 = transform @ pose1; src/tgt moved by pose1/pose2.
MVP_CP h5 keys: incomplete_pcds, complete_pcds, labels; 26 partial scans per
complete model (gt index = index // 26).
"""

from __future__ import annotations

import dataclasses

import numpy as np


# ---------------------------------------------------------------------------
# Pose synthesis
# ---------------------------------------------------------------------------

def _random_rotation_np(rng: np.random.Generator, max_angle: float,
                        min_angle: float = 0.0):
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    angle = min_angle + rng.random() * (max_angle - min_angle)
    a = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    r = np.eye(3) + np.sin(angle) * a + (1 - np.cos(angle)) * (a @ a)
    return r, angle


def random_pose_np(rng: np.random.Generator, max_angle: float, max_trans: float,
                   min_angle: float = 0.0) -> np.ndarray:
    """4x4 random rigid pose: uniform-axis rotation + random translation."""
    r, _ = _random_rotation_np(rng, max_angle, min_angle)
    t = rng.standard_normal(3)
    t /= np.linalg.norm(t)
    t *= rng.random() * max_trans
    pose = np.eye(4)
    pose[:3, :3] = r
    pose[:3, 3] = t
    return pose


def random_poses_np(rng: np.random.Generator, n: int, max_angle: float,
                    max_trans: float, min_angle: float = 0.0) -> np.ndarray:
    """Vectorized ``random_pose_np``: (n, 4, 4) in one shot — the data
    layer's batch path (the reference synthesizes poses one sample at a
    time in __getitem__; per-sample numpy loops become the host bottleneck
    for data-parallel training)."""
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = min_angle + rng.random(n) * (max_angle - min_angle)
    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    zeros = np.zeros(n)
    a = np.stack(
        [zeros, -z, y, z, zeros, -x, -y, x, zeros], axis=1
    ).reshape(n, 3, 3)
    eye = np.broadcast_to(np.eye(3), (n, 3, 3))
    r = eye + np.sin(angle)[:, None, None] * a \
        + (1 - np.cos(angle))[:, None, None] * (a @ a)
    t = rng.standard_normal((n, 3))
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    t *= (rng.random(n) * max_trans)[:, None]
    pose = np.broadcast_to(np.eye(4), (n, 4, 4)).copy()
    pose[:, :3, :3] = r
    pose[:, :3, 3] = t
    return pose


# ---------------------------------------------------------------------------
# Synthetic MVP-like data
# ---------------------------------------------------------------------------

def _random_shape(rng: np.random.Generator, n_points: int) -> np.ndarray:
    """A random 'object': points on the surfaces of 3-6 ellipsoid blobs."""
    n_blobs = int(rng.integers(3, 7))
    centers = rng.uniform(-0.3, 0.3, (n_blobs, 3))
    radii = rng.uniform(0.05, 0.25, (n_blobs, 3))
    counts = np.full(n_blobs, n_points // n_blobs)
    counts[: n_points - counts.sum()] += 1
    pts = []
    for c, r, k in zip(centers, radii, counts):
        v = rng.standard_normal((k, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pts.append(c + v * r)
    cloud = np.concatenate(pts, 0)
    # normalize to unit-ish scale like MVP clouds
    cloud -= cloud.mean(0)
    cloud /= np.abs(cloud).max() * 2.0
    return cloud.astype(np.float32)


def _structured_shape(rng: np.random.Generator, n_points: int) -> np.ndarray:
    """A furniture-like object: flat panels + bars + an optional tube.

    MVP clouds are scans of man-made objects (chairs, cars, lamps) whose
    flat surfaces and right angles give registration sharp, well-separated
    minima — unlike ellipsoid blobs, where wrong-window alignments can
    reach losses below the reference's 0.030 retry threshold
    (BENCH_NOTES r1 'Quality'). This generator exists so quality gates can
    run at MVP-like statistics without the (undistributed) .h5 files."""
    parts = []
    weights = []
    # asymmetric backbone: two UNEQUAL orthogonal panels sharing an edge
    # (seat + back of a chair) — breaks the rotational near-symmetries
    # that let wrong-window alignments reach low truncated CD
    q0 = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    u0, v0, w0 = q0
    a_seat = rng.uniform(0.35, 0.5)
    b_seat = rng.uniform(0.25, 0.4)
    a_back = a_seat * rng.uniform(0.5, 0.7)
    b_back = b_seat * rng.uniform(1.3, 1.8)
    c0 = rng.uniform(-0.1, 0.1, 3)
    s = rng.uniform(-1, 1, (384, 1))
    t = rng.uniform(-1, 1, (384, 1))
    parts.append(c0 + s * u0 * a_seat + t * v0 * b_seat)
    weights.append(a_seat * b_seat)
    # back panel: hinged on the seat's +u edge, extending along w
    c1 = c0 + u0 * a_seat
    s = rng.uniform(-1, 1, (384, 1))
    t = rng.uniform(0, 1, (384, 1))
    parts.append(c1 + s * v0 * a_back + t * w0 * b_back)
    weights.append(a_back * b_back)
    n_parts = int(rng.integers(1, 4))
    for _ in range(n_parts):
        kind = rng.choice(["panel", "bar", "bar", "tube"])
        center = rng.uniform(-0.35, 0.35, 3)
        # random orthonormal frame
        q = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        u, v, w = q
        if kind == "panel":
            a, b = rng.uniform(0.15, 0.45, 2)
            s = rng.uniform(-1, 1, (256, 1))
            t = rng.uniform(-1, 1, (256, 1))
            pts = center + s * u * a + t * v * b
            weights.append(a * b)
        elif kind == "bar":
            ln = rng.uniform(0.3, 0.7)
            r = rng.uniform(0.01, 0.04)
            s = rng.uniform(-1, 1, (256, 1))
            ang = rng.uniform(0, 2 * np.pi, (256, 1))
            pts = (center + s * w * ln
                   + np.cos(ang) * u * r + np.sin(ang) * v * r)
            weights.append(ln * r * 6)
        else:  # tube
            ln = rng.uniform(0.2, 0.5)
            r = rng.uniform(0.05, 0.15)
            s = rng.uniform(-1, 1, (256, 1))
            ang = rng.uniform(0, 2 * np.pi, (256, 1))
            pts = (center + s * w * ln
                   + np.cos(ang) * u * r + np.sin(ang) * v * r)
            weights.append(ln * r * 6)
        parts.append(pts)
    # sample parts proportionally to surface area
    weights = np.asarray(weights) / np.sum(weights)
    counts = rng.multinomial(n_points, weights)
    chosen = []
    for pts, k in zip(parts, counts):
        idx = rng.choice(len(pts), k, replace=k > len(pts))
        chosen.append(pts[idx])
    cloud = np.concatenate(chosen, 0)
    cloud -= cloud.mean(0)
    # MVP registration clouds span roughly the unit cube; at half that
    # scale wrong-window losses sit below the reference's 0.030 retry
    # threshold (losses are sqrt-distance means -> linear in scale)
    cloud /= np.abs(cloud).max()
    return cloud.astype(np.float32)


def _random_direction(rng: np.random.Generator,
                      near: np.ndarray | None = None,
                      max_angle_deg: float = 75.0) -> np.ndarray:
    """Uniform direction, optionally constrained within a cone of `near`
    (matched MVP views share overlap — match_id semantics)."""
    while True:
        d = rng.standard_normal(3)
        d /= np.linalg.norm(d)
        if near is None or np.degrees(np.arccos(np.clip(d @ near, -1, 1))) <= max_angle_deg:
            return d


def _partial_view(rng: np.random.Generator, cloud: np.ndarray,
                  n_points: int, direction: np.ndarray | None = None) -> np.ndarray:
    """Partial scan: keep the half of the cloud most aligned with a view
    direction, resample to n_points (mimics MVP's 26-view partials)."""
    d = direction if direction is not None else _random_direction(rng)
    score = cloud @ d
    keep = np.argsort(-score)[: max(n_points, len(cloud) // 2)]
    sel = cloud[keep]
    idx = rng.choice(len(sel), n_points, replace=len(sel) < n_points)
    return sel[idx].astype(np.float32)


def synthesize_registration_pairs(
    n_pairs: int,
    n_points: int = 2048,
    max_angle_deg: float = 45.0,
    max_trans: float = 0.5,
    seed: int = 2021,
    shape_mode: str = "blobs",
    rot_mix: bool = False,
):
    """Synthetic MVP_RG-like arrays: dict with src, tgt (canonical-frame
    partial views), rotated_src, rotated_tgt, transforms, cat_labels,
    match_level, rot_level.

    transforms maps rotated_src into rotated_tgt's frame (the quantity HOUV
    estimates; reference dataset.py:125-130 semantics).

    shape_mode 'structured' uses panel/bar objects whose CD landscape
    matches man-made MVP scans (sharp minima, wrong windows well above the
    0.030 retry threshold); 'blobs' keeps the r1 ellipsoid generator.
    rot_mix=True reproduces MVP's rot_level statistics: half the pairs get
    rotations <= 45° (rot_level 0), half in (45°, max_angle_deg]
    (rot_level 1); match_level 1 pairs share a tight view cone (high
    overlap), match_level 0 a wide one."""
    rng = np.random.default_rng(seed)
    max_angle = np.radians(max_angle_deg)
    make_shape = _structured_shape if shape_mode == "structured" \
        else _random_shape
    src = np.empty((n_pairs, n_points, 3), np.float32)
    tgt = np.empty_like(src)
    rotated_src = np.empty_like(src)
    rotated_tgt = np.empty_like(src)
    transforms = np.empty((n_pairs, 4, 4), np.float32)
    pose_src = np.empty((n_pairs, 4, 4), np.float32)
    pose_tgt = np.empty((n_pairs, 4, 4), np.float32)
    complete = np.empty((n_pairs, 2 * n_points, 3), np.float32)
    match_level = rng.integers(0, 2, n_pairs).astype(np.int32)
    rot_level = np.zeros(n_pairs, np.int32)
    for i in range(n_pairs):
        shape = make_shape(rng, 4 * n_points)
        d_src = _random_direction(rng)
        cone = 40.0 if match_level[i] else 60.0
        d_tgt = _random_direction(rng, near=d_src, max_angle_deg=cone)
        src[i] = _partial_view(rng, shape, n_points, d_src)
        tgt[i] = _partial_view(rng, shape, n_points, d_tgt)
        if rot_mix:
            rot_level[i] = i % 2
            lo, hi = ((0.0, np.radians(45.0)) if rot_level[i] == 0
                      else (np.radians(45.0), max(max_angle,
                                                  np.radians(46.0))))
            transform = random_pose_np(rng, hi, max_trans / 2, min_angle=lo)
        else:
            transform = random_pose_np(rng, max_angle, max_trans / 2)
            rot_level[i] = int(max_angle_deg > 45)
        pose1 = random_pose_np(rng, np.pi, max_trans)
        pose2 = transform @ pose1
        rotated_src[i] = src[i] @ pose1[:3, :3].T + pose1[:3, 3]
        rotated_tgt[i] = tgt[i] @ pose2[:3, :3].T + pose2[:3, 3]
        transforms[i] = transform
        pose_src[i] = pose1
        pose_tgt[i] = pose2
        complete[i] = shape[: 2 * n_points]
    # ragged per-pair matching-view index lists (reference match_id is an
    # h5 GROUP of variable-length int arrays, dataset.py:77-80)
    match_id = [
        np.sort(rng.choice(n_pairs, rng.integers(1, min(6, n_pairs) + 1),
                           replace=False)).astype(np.int64)
        for _ in range(n_pairs)
    ]
    return {
        "src": src,
        "tgt": tgt,
        "rotated_src": rotated_src,
        "rotated_tgt": rotated_tgt,
        "transforms": transforms,
        "complete": complete,
        "pose_src": pose_src,
        "pose_tgt": pose_tgt,
        "cat_labels": rng.integers(0, 16, n_pairs).astype(np.int32),
        "match_level": match_level,
        "rot_level": rot_level,
        "match_id": match_id,
    }


def synthesize_completion_set(
    n_models: int,
    views_per_model: int = 26,
    n_partial: int = 2048,
    n_complete: int = 2048,
    seed: int = 2021,
):
    """Synthetic MVP_CP-like arrays: incomplete_pcds (M·V, n_partial, 3),
    complete_pcds (M, n_complete, 3), labels (M·V,)."""
    rng = np.random.default_rng(seed)
    complete = np.empty((n_models, n_complete, 3), np.float32)
    partial = np.empty((n_models * views_per_model, n_partial, 3), np.float32)
    labels = np.empty(n_models * views_per_model, np.int32)
    for m in range(n_models):
        shape = _random_shape(rng, 2 * n_complete)
        complete[m] = shape[rng.choice(len(shape), n_complete, replace=False)]
        lab = int(rng.integers(0, 16))
        for v in range(views_per_model):
            partial[m * views_per_model + v] = _partial_view(rng, shape,
                                                             n_partial)
            labels[m * views_per_model + v] = lab
    return {
        "incomplete_pcds": partial,
        "complete_pcds": complete,
        "labels": labels,
    }


# ---------------------------------------------------------------------------
# H5 IO (reference schema)
# ---------------------------------------------------------------------------

def load_h5(path: str, keys=None) -> dict:
    """Load (a subset of) an MVP h5 file into numpy arrays (needs h5py,
    imported here so that the synthetic path runs without it)."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        for k in keys or f.keys():
            if isinstance(f[k], h5py.Group):  # ragged match_id group
                out[k] = [np.array(f[k][str(i)][:]) for i in range(len(f[k]))]
            else:
                out[k] = np.array(f[k][()])
    return out


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MVPRegistrationDataset:
    """MVP_RG with the reference's split semantics
    (registration/dataset.py:55-151):

    - train: canonical-frame src/tgt + on-the-fly pose synthesis per draw,
    - val:   precomputed rotated_src/rotated_tgt + transforms + levels,
    - test:  rotated_src/rotated_tgt only.

    Supports [l, r) index-range sharding like MVP_RG_rotated_bound
    (dataset.py:354-478)."""

    split: str
    path: str | None = None
    data: dict | None = None
    max_angle_deg: float = 45.0
    max_trans: float = 0.5
    index_range: tuple[int, int] | None = None
    category: int | None = None

    def __post_init__(self):
        if self.data is None:
            if self.path is None:
                raise ValueError("need path or data")
            self.data = load_h5(self.path)
        d = self.data
        if self.split == "train":
            self.src, self.tgt = d["src"], d["tgt"]
        else:
            self.src, self.tgt = d["rotated_src"], d["rotated_tgt"]
        self.labels = d.get("cat_labels")
        self.transforms = d.get("transforms") if self.split == "val" else None
        self.match_level = d.get("match_level")
        self.rot_level = d.get("rot_level")
        if self.category is not None and self.labels is not None:
            m = self.labels == self.category
            self.src, self.tgt = self.src[m], self.tgt[m]
            if self.transforms is not None:
                self.transforms = self.transforms[m]
            for name in ("match_level", "rot_level"):
                v = getattr(self, name)
                if v is not None:
                    setattr(self, name, v[m])
            self.labels = self.labels[m]
        if self.index_range is not None:
            l, r = self.index_range
            self.src, self.tgt = self.src[l:r], self.tgt[l:r]
            if self.transforms is not None:
                self.transforms = self.transforms[l:r]

    def __len__(self):
        return len(self.src)

    def get_batch(self, indices, rng: np.random.Generator | None = None):
        """Batch dict of numpy arrays. For train, poses are synthesized here
        (host-side, cheap) exactly like the reference's __getitem__."""
        src = self.src[indices].astype(np.float32)
        tgt = self.tgt[indices].astype(np.float32)
        if self.split == "train":
            rng = rng or np.random.default_rng()
            max_angle = np.radians(self.max_angle_deg)
            b = len(src)
            transforms = random_poses_np(
                rng, b, max_angle, self.max_trans / 2
            ).astype(np.float32)
            pose1 = random_poses_np(rng, b, np.pi, self.max_trans)
            pose2 = transforms @ pose1.astype(np.float32)
            src = np.einsum("bij,bnj->bni", pose1[:, :3, :3], src) \
                + pose1[:, None, :3, 3]
            tgt = np.einsum("bij,bnj->bni", pose2[:, :3, :3], tgt) \
                + pose2[:, None, :3, 3]
            batch = {"src": src.astype(np.float32),
                     "tgt": tgt.astype(np.float32),
                     "transform": transforms}
        elif self.split == "val":
            batch = {
                "src": src,
                "tgt": tgt,
                "transform": self.transforms[indices].astype(np.float32),
            }
        else:
            batch = {"src": src, "tgt": tgt}
        if self.match_level is not None and self.split != "test":
            batch["match_level"] = self.match_level[indices]
        if self.rot_level is not None and self.split != "test":
            rl = self.rot_level
            batch["rot_level"] = (
                rl[indices] if np.ndim(rl) > 0 else np.full(len(src), rl)
            )
        return batch


@dataclasses.dataclass
class MVPCompletionDataset:
    """MVP_CP (reference completion/dataset.py:12-61): 26 partials per
    complete model, gt = complete[index // 26], train scale aug uniform in
    {0.8, ..., 1.2}. ``with_voxels`` (the MVP_CP_EX grid indices of
    ``vrcnet_knn``) is not ported yet."""

    split: str
    path: str | None = None
    data: dict | None = None
    views_per_model: int = 26
    scale_aug: bool = True
    index_range: tuple[int, int] | None = None
    category: int | None = None
    with_voxels: bool = False

    def __post_init__(self):
        if self.with_voxels:
            raise NotImplementedError(
                "voxel grid indices (vrcnet_knn) are not ported yet "
                "(ROADMAP.md Queue 1, item 8)")
        if self.data is None:
            if self.path is None:
                raise ValueError("need path or data")
            self.data = load_h5(self.path)
        d = self.data
        self.partial = d["incomplete_pcds"]
        self.complete = d.get("complete_pcds", d["incomplete_pcds"])
        self.labels = d["labels"]
        # orig_idx maps dataset rows back to full-file rows so that
        # gt = complete[orig // views] survives slicing and filtering
        self.orig_idx = np.arange(len(self.partial))
        if self.index_range is not None:
            l, r = self.index_range
            self.partial = self.partial[l:r]
            self.labels = self.labels[l:r]
            self.orig_idx = self.orig_idx[l:r]
        if self.category is not None:
            m = np.asarray(self.labels) == self.category
            self.partial = self.partial[m]
            self.labels = np.asarray(self.labels)[m]
            self.orig_idx = self.orig_idx[m]

    def __len__(self):
        return len(self.partial)

    def get_batch(self, indices, rng: np.random.Generator | None = None):
        indices = np.asarray(indices)
        partial = self.partial[indices].astype(np.float32)
        labels = self.labels[indices].astype(np.int32)
        if self.split == "test":
            return {"partial": partial, "label": labels}
        gt_idx = self.orig_idx[indices] // self.views_per_model
        gt = self.complete[gt_idx].astype(np.float32)
        if self.split == "train" and self.scale_aug:
            rng = rng or np.random.default_rng()
            # uniform over {0.8, 0.9, 1.0, 1.1, 1.2} like randint(8,12)/10
            alpha = rng.integers(8, 13, len(indices)) / 10.0
            partial = partial * alpha[:, None, None].astype(np.float32)
            gt = gt * alpha[:, None, None].astype(np.float32)
        return {"partial": partial, "gt": gt, "label": labels}
