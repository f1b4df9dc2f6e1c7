"""SpecialEuclidean(3) in plain PyTorch, for the SE(3) cells' checks.

A point is (t_x, t_y, t_z, q_w, q_x, q_y, q_z): a translation and a unit
quaternion, the port's storage.  A tangent is (rho, phi), rho in the
translation's coordinates and phi the rotation vector.  ``exp(p, X) = p o
Exp(X)`` and ``log(p, q) = Log(p^-1 o q)`` (right perturbation, as upstream's
``ManifoldPrior`` and ``ManifoldFactor`` use them on RoME's ``Pose3``,
``SpecialEuclidean(3)``); ``Exp`` is the group exponential, the translation
``V(phi) rho``.

Written apart from the port, from the group's formulas: a rotation acts by
the quaternion's sandwich product q v q*, ``Log`` takes the principal
rotation (angle at most pi, whichever sign the quaternion's w has), and
V^-1 takes its coefficient of K^2 from the half angle, ``(1 - (theta/2)
cot(theta/2)) / theta^2``, with its series where theta is small; K v is
phi x v.  Every product is elementwise, in the inputs' dtype (float64 for
the reference, a lower precision for the control): no matrix is
multiplied, so no TF32 enters (``precision.matmul_mode``), and a read of
33,000 x 33,000 pairs holds no 3 x 3 matrix a pair.
"""

from __future__ import annotations

import torch

#: below this angle the series stand in for the closed forms
_SMALL = 1e-4


def _cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], -1)


def rotate(q, v):
    """v turned by the unit quaternion ``q`` (w first): the vector part of
    q (0, v) q*, that is v + 2 w (u x v) + 2 u x (u x v)."""
    w, u = q[..., :1], q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def _unit(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _safe(theta):
    small = theta < _SMALL
    return small, torch.where(small, torch.ones_like(theta), theta)


class SE3:
    """SpecialEuclidean(3)."""

    dof = 6
    point_dim = 7

    @staticmethod
    def identity(dtype=torch.float64, device=None):
        return torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0], dtype=dtype,
                            device=device)

    def compose(self, p, q):
        qp = _unit(p[..., 3:])
        t = p[..., :3] + rotate(qp, q[..., :3])
        return torch.cat([t, _unit(quat_mul(qp, q[..., 3:]))], dim=-1)

    def inverse(self, p):
        r = _unit(torch.cat([p[..., 3:4], -p[..., 4:]], dim=-1))
        return torch.cat([-rotate(r, p[..., :3]), r], dim=-1)

    def Exp(self, X):
        rho, phi = X[..., :3], X[..., 3:]
        theta = torch.linalg.vector_norm(phi, dim=-1, keepdim=True)
        small, th = _safe(theta)
        t2 = theta * theta
        # sin(theta/2)/theta, (1 - cos theta)/theta^2, (theta - sin
        # theta)/theta^3
        h = torch.where(small, 0.5 - t2 / 48.0, torch.sin(th / 2) / th)
        a = torch.where(small, 0.5 - t2 / 24.0, (1 - torch.cos(th)) / th ** 2)
        b = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                        (th - torch.sin(th)) / th ** 3)
        k1 = _cross(phi, rho)
        t = rho + a * k1 + b * _cross(phi, k1)          # V(phi) rho
        return torch.cat([t, torch.cos(theta / 2), h * phi], dim=-1)

    def Log(self, p):
        q = _unit(p[..., 3:])
        q = torch.where(q[..., :1] < 0, -q, q)        # the principal angle
        w, v = q[..., :1], q[..., 1:]
        s = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        theta = 2.0 * torch.atan2(s, w)
        small, th = _safe(theta)
        ss = torch.where(small, torch.ones_like(s), s)
        t2 = theta * theta
        # phi = theta v / |v| (2 atan(x) / x v / w, x = |v| / w, by its
        # series where small), and V^-1's coefficient of K^2 from the half
        # angle, cot(theta/2) = w / |v|
        x2 = (s / w) ** 2
        phi = torch.where(small, 2.0 / w * (1.0 - x2 / 3.0 + x2 * x2 / 5.0),
                          th / ss) * v
        c = torch.where(small, 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
                        (1.0 - th * w / (2.0 * ss)) / th ** 2)
        d = p[..., :3]
        k1 = _cross(phi, d)
        return torch.cat([d - 0.5 * k1 + c * _cross(phi, k1), phi], dim=-1)

    def exp(self, p, X):
        return self.compose(p, self.Exp(X))

    def log(self, p, q):
        return self.Log(self.compose(self.inverse(p), q))

    def mean(self, points, iters: int = 30):
        """Karcher mean: Gauss-Newton from the first point, a fixed count
        of steps (far more than the cells' particle clouds need)."""
        p = points[..., 0, :]
        for _ in range(iters):
            p = self.exp(p, self.log(p[..., None, :], points).mean(dim=-2))
        return p


def chain_start(labels, factors):
    """A start for ``gaussian.posterior`` on SE(3): each prior's point,
    then each relative factor's measurement composed onto a variable
    already placed (``gaussian.chain_start`` with a 7-number point)."""
    M = SE3()
    idx = {lbl: k for k, lbl in enumerate(labels)}
    x = M.identity().repeat(len(labels), 1)
    placed = set()
    for vs, value, _ in factors:
        if len(vs) == 1:
            x[idx[vs[0]]] = torch.as_tensor(value, dtype=torch.float64)
            placed.add(vs[0])
    for _ in range(len(labels)):
        for vs, value, _ in factors:
            if len(vs) == 2 and vs[0] in placed and vs[1] not in placed:
                x[idx[vs[1]]] = M.exp(
                    x[idx[vs[0]]], torch.as_tensor(value, dtype=torch.float64))
                placed.add(vs[1])
    return x
