"""Homogeneous-transform chain for the blasting nozzle.

Port of `mpc_blaster_tpu/core/htm.py`: body -> swivel-1 -> swivel-2 ->
nozzle with the reference's mount offsets, and world -> body from ZYX
Euler angles. Transforms are assembled with `torch.cat` (no in-place
writes) so the POC solver can take `torch.func.jacfwd` through them.
"""
from __future__ import annotations

import torch

from mpc_blaster_tpu_torch.core.rotations import (euler_zyx_to_rot, rot_x,
                                                  rot_y, rot_z)

# Mount offsets of the reference nozzle chain.
OFFSET_B_S1 = (0.01672, 0.0, -0.22937)
OFFSET_S1_S2 = (0.0425, 0.0, 0.0)
OFFSET_S2_N = (-0.05322, 0.0, -0.15946)


def _make_T(R: torch.Tensor, t) -> torch.Tensor:
    t = torch.as_tensor(t, dtype=R.dtype, device=R.device)
    top = torch.cat([R, t.reshape(3, 1)], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=R.dtype,
                          device=R.device)
    return torch.cat([top, bottom], dim=0)


def T_b_s2(alpha1: torch.Tensor, alpha2: torch.Tensor) -> torch.Tensor:
    """Body-to-nozzle transform: translate(b->s1) @ [Ry(alpha1) | t_s1s2]
    @ [Rx(-alpha2) | t_s2n], the reference's composition (its hs2n uses
    the transpose convention for alpha2)."""
    a1 = torch.as_tensor(alpha1)
    a2 = torch.as_tensor(alpha2)
    dtype = torch.promote_types(torch.promote_types(a1.dtype, a2.dtype),
                                torch.float32)
    a1, a2 = a1.to(dtype), a2.to(dtype)
    eye = torch.eye(3, dtype=dtype, device=a1.device)
    h_b_s1 = _make_T(eye, OFFSET_B_S1)
    h_s1_s2 = _make_T(rot_y(a1), OFFSET_S1_S2)
    h_s2_n = _make_T(rot_x(-a2), OFFSET_S2_N)
    return h_b_s1 @ h_s1_s2 @ h_s2_n


def T_w_b(eul: torch.Tensor, position: torch.Tensor,
          convention: str = "htm") -> torch.Tensor:
    """World-to-body transform from [phi, theta, psi] + position.

    ``convention="htm"`` reproduces the reference's extrinsic
    R = Rx(phi) Ry(theta) Rz(psi); ``"model"`` uses the dynamics'
    intrinsic ZYX composition. They agree to first order at eul = 0.
    """
    if convention == "htm":
        R = rot_x(eul[..., 0]) @ rot_y(eul[..., 1]) @ rot_z(eul[..., 2])
    elif convention == "model":
        R = euler_zyx_to_rot(eul)
    else:
        raise ValueError(f"unknown euler convention: {convention}")
    return _make_T(R, position)


def nozzle_pose(eul: torch.Tensor, alpha: torch.Tensor,
                position: torch.Tensor, convention: str = "htm"):
    """(p_nozzle_world, R_world_from_nozzle) for jet initialization."""
    T = T_w_b(eul, position, convention) @ T_b_s2(alpha[..., 0],
                                                  alpha[..., 1])
    return T[:3, 3], T[:3, :3]
