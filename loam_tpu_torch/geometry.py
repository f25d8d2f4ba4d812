"""SE(3) and geometric primitives on torch tensors.

The counterpart of ``loam_tpu.geometry`` (itself the analogue of the
reference's ``geometry.h`` / ``geometry.cpp``), the whole of its public
surface: the quaternion ops, ``Pose3``, the SE(3) exponential and logarithm,
the closed-form symmetric 3x3 eigensolvers, the line/plane fits and the
point-to-line/plane distances.
Every function accepts arbitrary leading batch dimensions, and the
expressions keep ``loam_tpu``'s association so both packages round alike.

Conventions: quaternions are ``(..., 4)`` in ``[w, x, y, z]`` order
(Hamilton); a pose acts on points by ``p' = R p + t``; a plane is a unit
normal ``n`` and an offset ``d`` with ``n . p - d = 0``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .device import place


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis (broadcasting leading axes)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis as ``sqrt(sum(x * x))``."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


# ---------------------------------------------------------------------------
# Quaternion ops (wxyz, Hamilton convention)
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, batch_shape: Tuple[int, ...] = (), device=None) -> torch.Tensor:
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``q1 * q2`` on wxyz quaternions."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / norm(q, keepdim=True)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` (..., 3) by unit quaternion(s) ``q`` (..., 4):
    ``v' = v + 2 w (u x v) + 2 u x (u x v)``, ``u = q.xyz``."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_axis_angle(axis: torch.Tensor, angle) -> torch.Tensor:
    """Unit ``axis`` (..., 3) and ``angle`` (...) -> quaternion (..., 4)."""
    half = 0.5 * torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], dim=-1)


def quat_exp(rotvec: torch.Tensor) -> torch.Tensor:
    """so(3) exponential: rotation vector (..., 3) -> unit quaternion (..., 4),
    with the Taylor form near zero."""
    theta_sq = torch.sum(rotvec * rotvec, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq)
    half = 0.5 * theta
    small = theta_sq < 1e-12
    one = torch.ones_like(theta)
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / torch.where(small, one, theta))
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([w, k * rotvec], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation vector (..., 3)."""
    q = torch.where(q[..., :1] < 0, -q, q)  # shortest arc
    u = q[..., 1:]
    un = norm(u, keepdim=True)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    angle = 2.0 * torch.atan2(un, w)
    small = un < 1e-9
    one = torch.ones_like(w)
    scale = torch.where(
        small, 2.0 / torch.where(w == 0, one, w), angle / torch.where(small, one, un)
    )
    return scale * u


def quat_angular_distance(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Angle of ``q1^-1 q2``, as Eigen's ``angularDistance``."""
    d = quat_multiply(quat_conjugate(q1), q2)
    return 2.0 * torch.atan2(norm(d[..., 1:]), torch.abs(d[..., 0]))


def _so3_V_apply(rotvec: torch.Tensor, v: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Apply the SO(3) left Jacobian ``V`` (or its inverse) to ``v``."""
    t2 = torch.sum(rotvec * rotvec, dim=-1, keepdim=True)
    t = torch.sqrt(t2)
    small = t2 < 1e-8
    one = torch.ones_like(t2)
    safe_t2 = torch.where(small, one, t2)
    if not inverse:
        a = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / safe_t2)
        b = torch.where(
            small,
            1.0 / 6.0 - t2 / 120.0,
            (t - torch.sin(t)) / (safe_t2 * torch.where(small, one, t)),
        )
    else:
        a = torch.full_like(t2, -0.5)
        s = torch.sin(t)
        safe = torch.where(small | (torch.abs(s) < 1e-12), one, 2.0 * t * s)
        c = 1.0 / safe_t2 - (1.0 + torch.cos(t)) / safe
        b = torch.where(small, 1.0 / 12.0 + t2 / 720.0, c)
    w_cross_v = cross(rotvec, v)
    w_cross2_v = cross(rotvec, w_cross_v)
    return v + a * w_cross_v + b * w_cross2_v


def se3_exp(xi: torch.Tensor) -> "Pose3":
    """SE(3) exponential: twist ``xi = (w, u)`` (..., 6) -> Pose3."""
    w = xi[..., :3]
    u = xi[..., 3:]
    return Pose3(quat_exp(w), _so3_V_apply(w, u, inverse=False))


def se3_log(pose: "Pose3") -> torch.Tensor:
    """SE(3) logarithm: Pose3 -> twist (..., 6), inverse of :func:`se3_exp`."""
    w = quat_log(pose.rotation)
    u = _so3_V_apply(w, pose.translation, inverse=True)
    return torch.cat([w, u], dim=-1)


# ---------------------------------------------------------------------------
# Pose3
# ---------------------------------------------------------------------------

class Pose3(NamedTuple):
    """SE(3) pose: quaternion (..., 4) wxyz + translation (..., 3)
    (reference ``Pose3d``, ``geometry.h:27-50``)."""

    rotation: torch.Tensor
    translation: torch.Tensor

    @staticmethod
    def identity(dtype=torch.float32, batch_shape: Tuple[int, ...] = (), device=None) -> "Pose3":
        return Pose3(
            quat_identity(dtype, batch_shape, device),
            torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device),
        )

    @staticmethod
    def from_numpy(pose, dtype=None, device=None) -> "Pose3":
        """Pose3 from any ``(rotation, translation)`` pair of array-likes,
        e.g. a ``loam_tpu`` pose converted with ``np.asarray``, on the card
        unless ``device`` says otherwise (``device.py``)."""
        rot, trans = pose
        return Pose3(place(rot, device, dtype), place(trans, device, dtype))

    def inverse(self) -> "Pose3":
        """Reference ``geometry.cpp:10-13``."""
        inv_rot = quat_conjugate(self.rotation)
        return Pose3(inv_rot, quat_rotate(inv_rot, -self.translation))

    def compose(self, other: "Pose3") -> "Pose3":
        """``self o other`` (reference ``geometry.cpp:16-18``)."""
        return Pose3(
            quat_multiply(self.rotation, other.rotation),
            self.translation + quat_rotate(self.rotation, other.translation),
        )

    def act(self, p: torch.Tensor) -> torch.Tensor:
        """``R p + t`` (reference ``geometry.cpp:21``)."""
        return quat_rotate(self.rotation, p) + self.translation

    def matrix(self) -> torch.Tensor:
        """4x4 homogeneous matrix (reference ``geometry.cpp:24-29``)."""
        t = self.translation
        m = torch.zeros(t.shape[:-1] + (4, 4), dtype=t.dtype, device=t.device)
        m[..., :3, :3] = quat_to_matrix(self.rotation)
        m[..., :3, 3] = t
        m[..., 3, 3] = 1.0
        return m

    def normalize(self) -> "Pose3":
        return Pose3(quat_normalize(self.rotation), self.translation)


def pose_from_rotvec(rotvec: torch.Tensor, translation: torch.Tensor) -> Pose3:
    return Pose3(quat_exp(rotvec), translation)


def pose_cumcompose(rel: Pose3) -> Pose3:
    """Prefix-compose relative poses along the leading axis:
    ``out[i] = rel[0] o ... o rel[i]``, sequentially (``loam_tpu`` uses an
    associative scan, whose tree order rounds differently)."""
    rots, trans = [rel.rotation[0]], [rel.translation[0]]
    for i in range(1, rel.rotation.shape[0]):
        r, t = rots[-1], trans[-1]
        rots.append(quat_multiply(r, rel.rotation[i]))
        trans.append(t + quat_rotate(r, rel.translation[i]))
    return Pose3(quat_normalize(torch.stack(rots)), torch.stack(trans))


# ---------------------------------------------------------------------------
# Lines and planes (batched, masked fitting)
# ---------------------------------------------------------------------------

def sym3x3_eigvalsh(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3) matrices, ascending, by the
    trigonometric solution of the characteristic cubic."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    B = A - q[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    safe_p = torch.where(p > 0, p, torch.ones_like(p))
    b00, b01, b02 = B[..., 0, 0], B[..., 0, 1], B[..., 0, 2]
    b10, b11, b12 = B[..., 1, 0], B[..., 1, 1], B[..., 1, 2]
    b20, b21, b22 = B[..., 2, 0], B[..., 2, 1], B[..., 2, 2]
    detB = (
        b00 * (b11 * b22 - b12 * b21)
        - b01 * (b10 * b22 - b12 * b20)
        + b02 * (b10 * b21 - b11 * b20)
    )
    r = torch.clamp(detB / (2.0 * safe_p**3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    e2 = q + 2.0 * p * torch.cos(phi)  # largest
    e0 = q + 2.0 * p * torch.cos(phi + two_pi_3)  # smallest
    e1 = 3.0 * q - e0 - e2
    eq = torch.stack([q, q, q], dim=-1)
    eig = torch.stack([e0, e1, e2], dim=-1)
    return torch.where((p == 0)[..., None], eq, eig)


def sym3x3_principal_eigvec(A: torch.Tensor, eigval: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of symmetric (..., 3, 3) ``A`` for the non-repeated
    eigenvalue ``eigval``, from the adjugate of ``A - eigval I``."""
    M = A - eigval[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c0 = cross(r1, r2)
    c1 = cross(r2, r0)
    c2 = cross(r0, r1)
    n0 = torch.sum(c0 * c0, dim=-1)
    n1 = torch.sum(c1 * c1, dim=-1)
    n2 = torch.sum(c2 * c2, dim=-1)
    best01 = torch.where((n0 >= n1)[..., None], c0, c1)
    nbest01 = torch.maximum(n0, n1)
    v = torch.where((nbest01 >= n2)[..., None], best01, c2)
    nv = torch.sqrt(torch.clamp(torch.maximum(nbest01, n2), min=1e-30))
    return v / nv[..., None]


def _outer_sum_small_k(centered: torch.Tensor) -> torch.Tensor:
    """``sum_k c[..., k, :] (x) c[..., k, :]`` with the small neighbor axis
    unrolled (the same summation order as ``loam_tpu``)."""
    K = centered.shape[-2]
    cov = centered[..., 0, :, None] * centered[..., 0, None, :]
    for k in range(1, K):
        cov = cov + centered[..., k, :, None] * centered[..., k, None, :]
    return cov


def fit_line(points: torch.Tensor, mask: torch.Tensor):
    """PCA line fit over masked points (reference ``geometry.cpp:42-59``).

    Args: points (..., K, 3), mask (..., K) bool.
    Returns: (a, b, condition_number) -- two points ``center +- 0.1 dir`` on
    the line and the computed ``eig2 / eig0`` ratio (the reference computes
    it but never assigns it, so its registration guard never fires; the
    caller decides whether to honor it).
    """
    dtype = points.dtype
    m = mask.to(dtype)[..., None]
    count = torch.clamp(torch.sum(m, dim=-2), min=1.0)
    center = torch.sum(points * m, dim=-2) / count
    centered = (points - center[..., None, :]) * m
    cov = _outer_sum_small_k(centered)
    eigvals = sym3x3_eigvalsh(cov)
    direction = sym3x3_principal_eigvec(cov, eigvals[..., 2])
    a = center + 0.1 * direction
    b = center - 0.1 * direction
    e0 = eigvals[..., 0]
    cond = eigvals[..., 2] / torch.where(torch.abs(e0) < 1e-12, torch.full_like(e0, 1e-12), e0)
    return a, b, cond


def fit_plane(points: torch.Tensor, mask: torch.Tensor):
    """Centered-PCA plane fit over masked points (reference
    ``geometry.cpp:62-73``, with ``loam_tpu``'s deliberate orthogonal
    least-squares divergence). The normal is oriented so ``d >= 0``.

    Returns: (normal (..., 3), d (...), avg_dist (...)); ``avg_dist`` is the
    signed mean residual, identically 0 for this fit.
    """
    dtype = points.dtype
    m = mask.to(dtype)[..., None]
    count = torch.clamp(torch.sum(m, dim=-2), min=1.0)
    centroid = torch.sum(points * m, dim=-2) / count
    centered = (points - centroid[..., None, :]) * m
    cov = _outer_sum_small_k(centered)
    eigvals = sym3x3_eigvalsh(cov)
    normal = sym3x3_principal_eigvec(cov, eigvals[..., 0])
    d = torch.sum(normal * centroid, dim=-1)
    flip = torch.where(d < 0, -1.0, 1.0).to(dtype)
    return normal * flip[..., None], d * flip, torch.zeros_like(d)


def _sym3x3_eigvalsh_c(xx, xy, xz, yy, yz, zz):
    """Component form of :func:`sym3x3_eigvalsh`: six covariance components
    -> (e0, e1, e2) ascending."""
    q = (xx + yy + zz) / 3.0
    bxx, byy, bzz = xx - q, yy - q, zz - q
    p2 = (bxx * bxx + byy * byy + bzz * bzz + 2.0 * (xy * xy + xz * xz + yz * yz)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    safe_p = torch.where(p > 0, p, torch.ones_like(p))
    detB = (
        bxx * (byy * bzz - yz * yz)
        - xy * (xy * bzz - yz * xz)
        + xz * (xy * yz - byy * xz)
    )
    r = torch.clamp(detB / (2.0 * safe_p**3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    e2 = q + 2.0 * p * torch.cos(phi)
    e0 = q + 2.0 * p * torch.cos(phi + two_pi_3)
    e1 = 3.0 * q - e0 - e2
    zero = p == 0
    return torch.where(zero, q, e0), torch.where(zero, q, e1), torch.where(zero, q, e2)


def _sym3x3_eigvec_c(xx, xy, xz, yy, yz, zz, e):
    """Component form of :func:`sym3x3_principal_eigvec`."""
    m00, m11, m22 = xx - e, yy - e, zz - e
    c0x = m11 * m22 - yz * yz
    c0y = yz * xz - xy * m22
    c0z = xy * yz - m11 * xz
    c1x = yz * xz - m22 * xy
    c1y = m22 * m00 - xz * xz
    c1z = xz * xy - yz * m00
    c2x = xy * yz - xz * m11
    c2y = xz * xy - m00 * yz
    c2z = m00 * m11 - xy * xy
    n0 = c0x * c0x + c0y * c0y + c0z * c0z
    n1 = c1x * c1x + c1y * c1y + c1z * c1z
    n2 = c2x * c2x + c2y * c2y + c2z * c2z
    use1 = n1 > n0
    bx = torch.where(use1, c1x, c0x)
    by = torch.where(use1, c1y, c0y)
    bz = torch.where(use1, c1z, c0z)
    nb = torch.maximum(n0, n1)
    use2 = n2 > nb
    vx = torch.where(use2, c2x, bx)
    vy = torch.where(use2, c2y, by)
    vz = torch.where(use2, c2z, bz)
    nv = torch.sqrt(torch.clamp(torch.maximum(nb, n2), min=1e-30))
    return vx / nv, vy / nv, vz / nv


def _packed_moments(xs, ys, zs, mask):
    """Masked mean + centered covariance components of (..., K, N) neighbors
    (the reduction runs over the K axis, second from last)."""
    m = mask.to(xs.dtype)
    n = torch.clamp(torch.sum(m, dim=-2), min=1.0)
    mx = torch.sum(xs * m, dim=-2) / n
    my = torch.sum(ys * m, dim=-2) / n
    mz = torch.sum(zs * m, dim=-2) / n
    cx = (xs - mx[..., None, :]) * m
    cy = (ys - my[..., None, :]) * m
    cz = (zs - mz[..., None, :]) * m
    s = lambda a, b: torch.sum(a * b, dim=-2)
    return (mx, my, mz), (s(cx, cx), s(cx, cy), s(cx, cz), s(cy, cy), s(cy, cz), s(cz, cz))


def fit_line_packed(xs, ys, zs, mask):
    """:func:`fit_line` from component-packed neighbors: xs/ys/zs/mask
    (..., K, N), the kNN kernel's output layout. Returns ((..., N, 3) a,
    (..., N, 3) b, (..., N) condition number)."""
    (mx, my, mz), cov = _packed_moments(xs, ys, zs, mask)
    e0, _, e2 = _sym3x3_eigvalsh_c(*cov)
    vx, vy, vz = _sym3x3_eigvec_c(*cov, e2)
    a = torch.stack([mx + 0.1 * vx, my + 0.1 * vy, mz + 0.1 * vz], dim=-1)
    b = torch.stack([mx - 0.1 * vx, my - 0.1 * vy, mz - 0.1 * vz], dim=-1)
    cond = e2 / torch.where(torch.abs(e0) < 1e-12, torch.full_like(e0, 1e-12), e0)
    return a, b, cond


def fit_plane_packed(xs, ys, zs, mask):
    """:func:`fit_plane` from component-packed (..., K, N) neighbors."""
    (mx, my, mz), cov = _packed_moments(xs, ys, zs, mask)
    e0, _, _ = _sym3x3_eigvalsh_c(*cov)
    vx, vy, vz = _sym3x3_eigvec_c(*cov, e0)
    d = vx * mx + vy * my + vz * mz
    flip = torch.where(d < 0, -1.0, 1.0).to(d.dtype)
    normal = torch.stack([vx * flip, vy * flip, vz * flip], dim=-1)
    return normal, d * flip, torch.zeros_like(d)


def point_to_line_distance(point: torch.Tensor, line_a: torch.Tensor, line_b: torch.Tensor) -> torch.Tensor:
    """``|(p-a) x (p-b)| / |a-b|`` (reference ``geometry-inl.h:21-27``)."""
    return norm(cross(point - line_a, point - line_b)) / norm(line_a - line_b)


def point_to_plane_distance(point: torch.Tensor, normal: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``|n . p - d|`` (reference ``geometry-inl.h:30-33``)."""
    return torch.abs(torch.sum(point * normal, dim=-1) - d)
