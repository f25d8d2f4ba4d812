"""Rotations for the plain reference: unit quaternions (w, x, y, z) and
poses as (quaternion, translation) pairs of tensors, in any floating dtype,
with leading batch axes."""

from __future__ import annotations

import torch


def qmul(a, b):
    """Hamilton product ``a b``."""
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def qconj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def qrot(q, v):
    """Rotate points ``v`` (..., 3) by ``q`` (broadcast over ``v``'s axes)."""
    u, w = q[..., 1:], q[..., :1]
    uv = torch.cross(u.expand(v.shape), v, dim=-1)
    return v + 2.0 * (w * uv + torch.cross(u.expand(v.shape), uv, dim=-1))


def qnormalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def qexp(r):
    """Rotation vector -> unit quaternion."""
    th2 = torch.sum(r * r, dim=-1, keepdim=True)
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    k = torch.where(small, 0.5 - th2 / 48.0, torch.sin(0.5 * th) / torch.where(small, torch.ones_like(th), th))
    w = torch.where(small, 1.0 - th2 / 8.0, torch.cos(0.5 * th))
    return torch.cat([w, k * r], dim=-1)


def qlog(q):
    """Unit quaternion -> rotation vector (shortest arc)."""
    q = torch.where(q[..., :1] < 0, -q, q)
    u = q[..., 1:]
    un = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    angle = 2.0 * torch.atan2(un, w)
    small = un < 1e-9
    one = torch.ones_like(w)
    return torch.where(small, 2.0 / torch.where(w == 0, one, w), angle / torch.where(small, one, un)) * u


def angle(q):
    """Rotation angle of a unit quaternion."""
    return 2.0 * torch.atan2(torch.linalg.vector_norm(q[..., 1:], dim=-1), torch.abs(q[..., 0]))


def compose(a, b):
    """Pose ``a o b``."""
    return qmul(a[0], b[0]), a[1] + qrot(a[0], b[1])


def inverse(p):
    qi = qconj(p[0])
    return qi, qrot(qi, -p[1])


def act(p, x):
    """``R x + t`` for points (..., N, 3) and a pose of the batch shape."""
    return qrot(p[0][..., None, :], x) + p[1][..., None, :]


def identity(batch, dtype, device):
    q = torch.zeros(tuple(batch) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q, torch.zeros(tuple(batch) + (3,), dtype=dtype, device=device)


def yaw_quat(yaw):
    """Quaternions of rotations about z by ``yaw`` (float64 tensor)."""
    h = 0.5 * yaw
    z = torch.zeros_like(h)
    return torch.stack([torch.cos(h), z, z, torch.sin(h)], dim=-1)
