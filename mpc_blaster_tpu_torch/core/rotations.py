"""Rotation and attitude kinematics as pure torch functions.

Port of `mpc_blaster_tpu/core/rotations.py`. Every function builds its
result with `torch.stack` (no in-place writes), so it runs under
`torch.func.jacfwd`/`vmap`.

Convention: ZYX (yaw-pitch-roll) Euler angles, world R = Rz(psi) Ry(theta)
Rx(phi). ENU world frame, gravity -z.
"""
from __future__ import annotations

import torch


def rot_x(a: torch.Tensor) -> torch.Tensor:
    """Rotation about x."""
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([
        torch.stack([o, z, z], -1),
        torch.stack([z, c, -s], -1),
        torch.stack([z, s, c], -1),
    ], -2)


def rot_y(a: torch.Tensor) -> torch.Tensor:
    """Rotation about y."""
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([
        torch.stack([c, z, s], -1),
        torch.stack([z, o, z], -1),
        torch.stack([-s, z, c], -1),
    ], -2)


def rot_z(a: torch.Tensor) -> torch.Tensor:
    """Rotation about z."""
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([
        torch.stack([c, -s, z], -1),
        torch.stack([s, c, z], -1),
        torch.stack([z, z, o], -1),
    ], -2)


def euler_zyx_to_rot(eul: torch.Tensor) -> torch.Tensor:
    """World-from-body rotation from [phi, theta, psi]."""
    phi, theta, psi = eul[..., 0], eul[..., 1], eul[..., 2]
    return rot_z(psi) @ rot_y(theta) @ rot_x(phi)


def euler_rate_matrix(eul: torch.Tensor) -> torch.Tensor:
    """E(eul) such that omega_body = E @ eul_dot."""
    phi, theta = eul[..., 0], eul[..., 1]
    z, o = torch.zeros_like(phi), torch.ones_like(phi)
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    return torch.stack([
        torch.stack([o, z, -sth], -1),
        torch.stack([z, cphi, sphi * cth], -1),
        torch.stack([z, -sphi, cphi * cth], -1),
    ], -2)


def euler_rates_from_omega(eul: torch.Tensor,
                           omega: torch.Tensor) -> torch.Tensor:
    """eul_dot = E(eul)^-1 omega, with the closed-form inverse
        E^-1 = [[1, sphi*tth,  cphi*tth],
                [0, cphi,     -sphi   ],
                [0, sphi/cth,  cphi/cth]]
    """
    phi, theta = eul[..., 0], eul[..., 1]
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth = torch.cos(theta)
    tth = torch.tan(theta)
    p, q, r = omega[..., 0], omega[..., 1], omega[..., 2]
    phi_dot = p + sphi * tth * q + cphi * tth * r
    theta_dot = cphi * q - sphi * r
    psi_dot = (sphi * q + cphi * r) / cth
    return torch.stack([phi_dot, theta_dot, psi_dot], -1)


def gimbal_rotation(alpha1: torch.Tensor,
                    alpha2: torch.Tensor) -> torch.Tensor:
    """Body-to-nozzle rotation Ry(alpha1) @ Rx(alpha2)."""
    return rot_y(alpha1) @ rot_x(alpha2)


# --- Quaternion helpers (q = [w, x, y, z]) ---

def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


def unit_quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Unit-quaternion inverse = conjugate."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix from unit quaternion."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([2 * (w * w + x * x) - 1, 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 2 * (w * w + y * y) - 1,
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     2 * (w * w + z * z) - 1], -1),
    ], -2)


def euler_zyx_to_quat(eul: torch.Tensor) -> torch.Tensor:
    """[w,x,y,z] quaternion from ZYX Euler angles ('sxyz' in transforms3d)."""
    half = eul * 0.5
    cph, sph = torch.cos(half[..., 0]), torch.sin(half[..., 0])
    cth, sth = torch.cos(half[..., 1]), torch.sin(half[..., 1])
    cps, sps = torch.cos(half[..., 2]), torch.sin(half[..., 2])
    return torch.stack([
        cph * cth * cps + sph * sth * sps,
        sph * cth * cps - cph * sth * sps,
        cph * sth * cps + sph * cth * sps,
        cph * cth * sps - sph * sth * cps,
    ], -1)


def quat_to_euler_zyx(q: torch.Tensor) -> torch.Tensor:
    """[phi, theta, psi] ZYX Euler from a [w,x,y,z] unit quaternion;
    theta is asin-clamped against |.|>1 roundoff."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    phi = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    theta = torch.asin(torch.clamp(2 * (w * y - x * z), -1.0, 1.0))
    psi = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([phi, theta, psi], -1)
