"""Lie groups SO(2), SE(2), SO(3), SE(3) and the sphere S² as coordinate
functions on tensors.

Counterpart of ``incrementalinference/jl_tpu/manifolds/lie.py``.

Point storage (fixed-shape coordinate tensors):
  SO2: (1,) angle            SE2: (3,)  x, y, theta
  SO3: (4,) unit quaternion  SE3: (7,)  x, y, z, qw, qx, qy, qz

All tangent vectors are coordinate (vee) vectors; all ops broadcast over
leading batch dimensions.  The batched Gauss-Newton differentiates through
these functions in reverse mode (``torch.func.jacrev`` under ``vmap``), so
nothing here writes in place or branches on data: every small-angle branch
is a double ``torch.where`` whose untaken side stays finite with a finite
derivative (the guarded divisor is 1 where the Taylor form is taken), since
reverse mode sends that side a zero cotangent and 0·inf is NaN; derivatives
stay finite at the zero tangent.  Scalar quantities (an angle, a norm) keep
a trailing dimension of size one: forward-mode differentiation of a
zero-dimensional tensor times a Python number can come back in float64,
which the Gauss-Newton's float32 solve then refuses.
"""

from __future__ import annotations

import torch

from .base import Circle, Manifold, wrap_angle

_EPS = 1e-8


def _snorm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Gradient-safe vector norm: ``torch.linalg.norm`` has a NaN derivative
    at exactly zero, which the Jacobians hit when linearising retractions at
    the zero tangent (the batched Gauss-Newton's base point every
    iteration)."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim) + 1e-24)


def _cols(a: torch.Tensor):
    """The last dimension's entries, each keeping a dimension of size 1."""
    return [a[..., i:i + 1] for i in range(a.shape[-1])]


class SO2(Circle):
    """SO(2) stored as an angle; group-wise identical to RealCircleGroup."""


# ---------------------------------------------------------------------------
# quaternion helpers (w, x, y, z), broadcasting over leading dimensions
# ---------------------------------------------------------------------------

def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = _cols(a)
    bw, bx, by, bz = _cols(b)
    return torch.cat([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    # canonical sign: w >= 0 (two-to-one cover)
    return torch.where(q[..., :1] < 0.0, -q, q)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last dimension, written out: it broadcasts,
    and forward-mode differentiation goes through plain products."""
    ax, ay, az = _cols(a)
    bx, by, bz = _cols(b)
    return torch.cat([ay * bz - az * by, az * bx - ax * bz,
                      ax * by - ay * bx], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vector v by unit quaternion q."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_from_rotvec(phi: torch.Tensor) -> torch.Tensor:
    t = _snorm(phi, keepdim=True)
    half = 0.5 * t
    safe = t > _EPS
    # sin(half)/t with Taylor fallback 0.5 - t^2/48
    st = torch.where(safe,
                     torch.sin(half) / torch.where(safe, t,
                                                   torch.ones_like(t)),
                     0.5 - t * t / 48.0)
    return torch.cat([torch.cos(half), st * phi], dim=-1)


def rotvec_from_quat(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    w = q[..., :1]
    u = q[..., 1:]
    un = _snorm(u, keepdim=True)
    angle = 2.0 * torch.atan2(un, w)
    safe = un > _EPS
    # angle/sin(angle/2) with fallback 2/w as un -> 0
    scale = torch.where(safe,
                        angle / torch.where(safe, un, torch.ones_like(un)),
                        2.0 / torch.clamp(w, min=_EPS))
    return scale * u


def _hat3(phi: torch.Tensor) -> torch.Tensor:
    x, y, z = _cols(phi)
    o = torch.zeros_like(x)
    return torch.stack([
        torch.cat([o, -z, y], dim=-1),
        torch.cat([z, o, -x], dim=-1),
        torch.cat([-y, x, o], dim=-1),
    ], dim=-2)


def _eye3_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def _se3_V(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V(phi) of SO(3): t = V @ rho in SE(3) exp."""
    t = _snorm(phi, keepdim=True)
    t2 = t * t
    safe = t > _EPS
    td = torch.where(safe, t, torch.ones_like(t))
    A = torch.where(safe, (1.0 - torch.cos(td)) / (td * td),
                    0.5 - t2 / 24.0)
    B = torch.where(safe, (td - torch.sin(td)) / (td * td * td),
                    1.0 / 6.0 - t2 / 120.0)
    K = _hat3(phi)
    return _eye3_like(K) + A[..., None] * K + B[..., None] * (K @ K)


def _se3_Vinv(phi: torch.Tensor) -> torch.Tensor:
    t = _snorm(phi, keepdim=True)
    t2 = t * t
    safe = t > _EPS
    td = torch.where(safe, t, torch.ones_like(t))
    # coefficient of K@K in V^-1: (1 - theta*sin/(2(1-cos))) / theta^2
    cot = torch.where(
        safe,
        (1.0 - 0.5 * td * torch.sin(td)
         / torch.clamp(1.0 - torch.cos(td), min=_EPS)) / (td * td),
        1.0 / 12.0 + t2 / 720.0,
    )
    K = _hat3(phi)
    return _eye3_like(K) - 0.5 * K + cot[..., None] * (K @ K)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(M * v[..., None, :], dim=-1)


# ---------------------------------------------------------------------------
# SE(2)
# ---------------------------------------------------------------------------

def _se2_AB(phi: torch.Tensor):
    """sin(phi)/phi and (1 - cos(phi))/phi with their Taylor forms."""
    safe = torch.abs(phi) > _EPS
    ph = torch.where(safe, phi, torch.ones_like(phi))
    A = torch.where(safe, torch.sin(ph) / ph, 1.0 - phi * phi / 6.0)
    B = torch.where(safe, (1.0 - torch.cos(ph)) / ph, 0.5 * phi)
    return A, B


class SE2(Manifold):
    """SpecialEuclidean(2): point (x, y, theta), tangent (rho_x, rho_y, phi)."""

    point_dim = 3
    dof = 3

    def identity(self, device=None):
        return torch.zeros((3,), dtype=torch.float32, device=device)

    def project(self, p):
        return torch.cat([p[..., :2], wrap_angle(p[..., 2:])], dim=-1)

    @staticmethod
    def _lin(a: torch.Tensor, b: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
        """[[a, -b], [b, a]] @ v with a, b of shape (..., 1)."""
        vx, vy = v[..., 0:1], v[..., 1:2]
        return torch.cat([a * vx - b * vy, b * vx + a * vy], dim=-1)

    @classmethod
    def _rot(cls, theta: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return cls._lin(torch.cos(theta), torch.sin(theta), v)

    def compose(self, p, q):
        t = p[..., :2] + self._rot(p[..., 2:], q[..., :2])
        return torch.cat([t, wrap_angle(p[..., 2:] + q[..., 2:])], dim=-1)

    def inverse(self, p):
        th = -p[..., 2:]
        return torch.cat([-self._rot(th, p[..., :2]), wrap_angle(th)],
                         dim=-1)

    @classmethod
    def Exp(cls, X: torch.Tensor) -> torch.Tensor:
        phi = X[..., 2:]
        A, B = _se2_AB(phi)
        return torch.cat([cls._lin(A, B, X[..., :2]), wrap_angle(phi)],
                         dim=-1)

    @classmethod
    def Log(cls, p: torch.Tensor) -> torch.Tensor:
        phi = wrap_angle(p[..., 2:])
        A, B = _se2_AB(phi)
        den = torch.clamp(A * A + B * B, min=_EPS)
        return torch.cat([cls._lin(A, -B, p[..., :2]) / den, phi], dim=-1)

    def exp(self, p, X):
        return self.compose(p, self.Exp(X))

    def log(self, p, q):
        return self.Log(self.compose(self.inverse(p), q))


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

class SO3(Manifold):
    """SpecialOrthogonal(3): unit quaternion point, rotation-vector tangent."""

    point_dim = 4
    dof = 3

    def identity(self, device=None):
        return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32,
                            device=device)

    def project(self, p):
        return quat_normalize(p)

    def compose(self, p, q):
        return quat_normalize(quat_mul(p, q))

    def inverse(self, p):
        return quat_conj(p)

    def exp(self, p, X):
        return quat_normalize(quat_mul(p, quat_from_rotvec(X)))

    def log(self, p, q):
        return rotvec_from_quat(quat_mul(quat_conj(p), q))


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

class SE3(Manifold):
    """SpecialEuclidean(3): point (t[3], quat[4]), tangent (rho[3], phi[3])."""

    point_dim = 7
    dof = 6

    def identity(self, device=None):
        return torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0],
                            dtype=torch.float32, device=device)

    def project(self, p):
        return torch.cat([p[..., :3], quat_normalize(p[..., 3:])], dim=-1)

    def compose(self, p, q):
        t = p[..., :3] + quat_rotate(p[..., 3:], q[..., :3])
        r = quat_normalize(quat_mul(p[..., 3:], q[..., 3:]))
        return torch.cat([t, r], dim=-1)

    def inverse(self, p):
        r = quat_conj(p[..., 3:])
        t = -quat_rotate(r, p[..., :3])
        return torch.cat([t, r], dim=-1)

    @staticmethod
    def Exp(X: torch.Tensor) -> torch.Tensor:
        rho, phi = X[..., :3], X[..., 3:]
        return torch.cat([_matvec(_se3_V(phi), rho), quat_from_rotvec(phi)],
                         dim=-1)

    @staticmethod
    def Log(p: torch.Tensor) -> torch.Tensor:
        phi = rotvec_from_quat(p[..., 3:])
        return torch.cat([_matvec(_se3_Vinv(phi), p[..., :3]), phi], dim=-1)

    def exp(self, p, X):
        return self.compose(p, self.Exp(X))

    def log(self, p, q):
        return self.Log(self.compose(self.inverse(p), q))


class Sphere2(Manifold):
    """Unit sphere S².  Points are unit 3-vectors; tangent coordinates live
    in a local orthonormal basis built from the point (smooth away from the
    -z pole; the helper axis switches at |p_z| = 0.9).  Not a group:
    compose/inverse are undefined; priors and relatives use exp/log only."""

    point_dim = 3
    dof = 2

    def identity(self, device=None):
        return torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                            device=device)

    def project(self, p):
        return p / torch.linalg.norm(p, dim=-1, keepdim=True)

    @staticmethod
    def _basis(p):
        """Two orthonormal tangent vectors at p."""
        # the helper axis least aligned with p: e_z, or e_x near the poles
        z = (torch.abs(p[..., 2:3]) < 0.9).to(p.dtype)
        a = torch.cat([1.0 - z, torch.zeros_like(z), z], dim=-1)
        b1 = _cross(a, p)
        b1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True),
                              min=_EPS)
        b2 = _cross(p, b1)
        return b1, b2

    def exp(self, p, X):
        b1, b2 = self._basis(p)
        v = X[..., 0:1] * b1 + X[..., 1:2] * b2          # ambient tangent
        t = _snorm(v, keepdim=True)
        ts = torch.clamp(t, min=_EPS)
        q = torch.cos(t) * p + torch.sin(t) * v / ts
        return self.project(torch.where(t > _EPS, q, p + v))

    def log(self, p, q):
        cos_t = torch.clamp(torch.sum(p * q, dim=-1, keepdim=True),
                            -1.0, 1.0)
        # acos' is infinite at 1 (q = p): reverse mode would send the zero
        # cotangent of the untaken branch below through it as 0·inf = NaN
        one = cos_t >= 1.0
        zero = torch.zeros_like(cos_t)
        t = torch.where(one, zero, torch.acos(torch.where(one, zero, cos_t)))
        v = q - cos_t * p                                # ambient direction
        vn = torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                         min=_EPS)
        w = torch.where(t > _EPS, t * v / vn, v)
        b1, b2 = self._basis(p)
        return torch.cat([torch.sum(w * b1, dim=-1, keepdim=True),
                          torch.sum(w * b2, dim=-1, keepdim=True)], dim=-1)
