"""Rigid-transform math on batched f32 tensors.

Counterpart of ``houv_tpu/geometry/rotations.py``. The JAX package runs these matmuls at ``Precision.HIGHEST``; here
they run in full f32 as long as ``torch.backends.cuda.matmul.allow_tf32``
stays False, which the solver sets.
"""

from __future__ import annotations

import math

import torch


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) vectors -> (..., 3, 3) cross-product matrices."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(angle: torch.Tensor, axis: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """R = I + sin(a)·A + (1-cos(a))·A², A = skew(axis/|axis|).

    angle (...,) or (..., 1) radians; axis (..., 3), any norm > 0."""
    if angle.dim() == axis.dim():
        angle = angle[..., 0]
    norm = torch.sqrt((axis * axis).sum(-1, keepdim=True) + eps)
    a = _skew(axis / norm)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    sin = torch.sin(angle)[..., None, None]
    cos1 = (1.0 - torch.cos(angle))[..., None, None]
    return eye + sin * a + cos1 * (a @ a)


# the reference's name
rotation_from_axis_angle = rodrigues


def rotation_xyz(angles_xyz: torch.Tensor) -> torch.Tensor:
    """R = Rx(ax) @ Ry(ay) @ Rz(az) from (..., 3) Euler-style angles, each
    factor a ``rodrigues`` about its unit axis."""
    eye = torch.eye(3, dtype=angles_xyz.dtype, device=angles_xyz.device)
    rx, ry, rz = (rodrigues(angles_xyz[..., i],
                            eye[i].expand(angles_xyz.shape))
                  for i in range(3))
    return (rx @ ry) @ rz


def rt_to_transformation(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) or (..., 3, 1) -> (..., 4, 4)."""
    if t.shape[-1] != 1:
        t = t[..., None]
    top = torch.cat([r, t], dim=-1)
    bot = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=r.dtype, device=r.device)
    bot = bot.expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bot], dim=-2)


def rotation_error(r: torch.Tensor, r_gt: torch.Tensor) -> torch.Tensor:
    """Angle in degrees between batched rotations, from trace(R·R_gtᵀ)."""
    cos_theta = ((r * r_gt).sum((-2, -1)) - 1.0) / 2.0
    return torch.arccos(cos_theta.clamp(-1.0, 1.0)) * (180.0 / math.pi)


def translation_error(t: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    """L2 norm of the translation difference."""
    return torch.linalg.norm(t - t_gt, dim=-1)


def rmse_loss(pts: torch.Tensor, t: torch.Tensor,
              t_gt: torch.Tensor) -> torch.Tensor:
    """Mean per-point distance between clouds moved by T and by T_gt."""
    pred = pts @ t[..., :3, :3].transpose(-1, -2) + t[..., None, :3, 3]
    gt = pts @ t_gt[..., :3, :3].transpose(-1, -2) + t_gt[..., None, :3, 3]
    return torch.linalg.norm(pred - gt, dim=-1).mean(-1)


def rotation_geodesic_error(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle in radians between rotations."""
    m = m1 @ m2.transpose(-1, -2)
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) / 2.0
    return torch.arccos(cos.clamp(-1.0, 1.0))


def normalize_translation(tran: torch.Tensor, scale: torch.Tensor,
                          eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize a direction and scale it (scale may be negative)."""
    norm = torch.sqrt((tran * tran).sum(-1, keepdim=True) + eps)
    return tran / norm * scale


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions laid out (x, y, z, w) -> (..., 3, 3) rotations,
    the reference's convention; not normalised inside."""
    x, y, z, w = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return m.reshape(quat.shape[:-1] + (3, 3))


def mat2euler(mats: torch.Tensor, seq: str = "zyx") -> torch.Tensor:
    """Rotations -> Euler angles in degrees, (..., 3) as [z, y, x]: 'zyx'
    scipy's extrinsic z-y-x (R = Rx(γ)·Ry(β)·Rz(α), the reference's), 'ZYX'
    the intrinsic one (R = Rz·Ry·Rx)."""
    r = mats
    if seq == "ZYX":
        z = torch.atan2(r[..., 1, 0], r[..., 0, 0])
        y = torch.asin(torch.clamp(-r[..., 2, 0], -1.0, 1.0))
        x = torch.atan2(r[..., 2, 1], r[..., 2, 2])
    elif seq == "zyx":
        z = -torch.atan2(r[..., 0, 1], r[..., 0, 0])
        y = torch.asin(torch.clamp(r[..., 0, 2], -1.0, 1.0))
        x = -torch.atan2(r[..., 1, 2], r[..., 2, 2])
    else:
        raise NotImplementedError("sequences: 'zyx' (reference) or 'ZYX'")
    return torch.stack([z, y, x], dim=-1) * (180.0 / math.pi)


def _pose_from_draws(axis: torch.Tensor, u_angle: torch.Tensor,
                     tdir: torch.Tensor, u_trans: torch.Tensor,
                     max_angle: float, max_trans: float) -> torch.Tensor:
    """``random_pose``'s transform from its draws: a normal (3,) axis, a
    uniform angle fraction, a normal (3,) direction and a uniform
    translation fraction."""
    axis = axis / torch.linalg.vector_norm(axis)
    r = rodrigues(u_angle * max_angle, axis)
    t = tdir / torch.linalg.vector_norm(tdir) * u_trans * max_trans
    return rt_to_transformation(r, t)


def random_pose(generator: torch.Generator, max_angle: float,
                max_trans: float) -> torch.Tensor:
    """One random (4, 4) rigid transform on the generator's device: an axis
    uniform on the sphere (a normalised normal draw), an angle uniform in
    [0, max_angle), a translation of uniform direction and norm uniform in
    [0, max_trans): the reference's train-time pose distribution."""
    dev = generator.device
    axis = torch.randn(3, generator=generator, device=dev)
    u_angle = torch.rand((), generator=generator, device=dev)
    tdir = torch.randn(3, generator=generator, device=dev)
    u_trans = torch.rand((), generator=generator, device=dev)
    return _pose_from_draws(axis, u_angle, tdir, u_trans, max_angle,
                            max_trans)


def transform_points(points: torch.Tensor, r: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) points moved by (..., 3, 3) rotations and (..., 3)
    translations."""
    return points @ r.transpose(-1, -2) + t[..., None, :]


def axis_angle_from_matrix(r: torch.Tensor, eps: float = 1e-7):
    """Rotations -> (angle in degrees in [0, 180], unit axis); the axis is
    z where the angle is too small to name one."""
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    angle = torch.acos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    axis = torch.stack([r[..., 2, 1] - r[..., 1, 2],
                        r[..., 0, 2] - r[..., 2, 0],
                        r[..., 1, 0] - r[..., 0, 1]], dim=-1)
    norm = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    axis = axis / torch.clamp_min(norm, eps)
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=r.dtype, device=r.device)
    axis = torch.where(norm > eps, axis, fallback.expand(axis.shape))
    return angle * (180.0 / math.pi), axis
