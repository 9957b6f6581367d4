"""BLASTER 17-state rigid-body + gimbal + POC dynamics as a pure function.

Port of `mpc_blaster_tpu/dynamics/blaster.py`. The ODE is written
functionally (no in-place writes to its inputs, no `.item()`), so
`torch.func.jacfwd` and `vmap` give its sensitivities. State, control and
parameter layout are those of `config.py`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.core.rotations import (
    euler_rates_from_omega,
    euler_zyx_to_rot,
    gimbal_rotation,
)
from mpc_blaster_tpu_torch.device import resolve_device


class BlasterParams(NamedTuple):
    """Physical constants of the vehicle that enter the ODE."""

    mass: torch.Tensor          # scalar
    inertia: torch.Tensor       # (3,) diagonal of J
    arm_length_x: torch.Tensor  # scalar
    arm_length_y: torch.Tensor  # scalar
    yaw_coefficient: torch.Tensor  # scalar c
    gravity: torch.Tensor       # scalar (positive magnitude)

    @staticmethod
    def from_config(model: cfg.ModelConfig, dtype=torch.float32,
                    device=None) -> "BlasterParams":
        device = resolve_device(device)

        def t(v):
            return torch.as_tensor(v, dtype=dtype, device=device)
        return BlasterParams(
            mass=t(model.mass),
            inertia=t(model.inertia_diag),
            arm_length_x=t(model.arm_length_x),
            arm_length_y=t(model.arm_length_y),
            yaw_coefficient=t(model.yaw_coefficient),
            gravity=t(model.gravity),
        )


def pack_stage_params(j_angles, j_euler, j_pos, t_blast) -> torch.Tensor:
    """(3,2), (3,3), (3,3), scalar -> 25-vector, column-major (the CasADi
    `reshape` packing of the reference model)."""
    j_angles = torch.as_tensor(j_angles)
    j_euler = torch.as_tensor(j_euler)
    j_pos = torch.as_tensor(j_pos)
    t_blast = torch.as_tensor(t_blast, dtype=j_pos.dtype,
                              device=j_pos.device)
    return torch.cat([
        j_angles.T.reshape(6),
        j_euler.T.reshape(9),
        j_pos.T.reshape(9),
        t_blast.reshape(1),
    ])


def unpack_stage_params(p: torch.Tensor):
    """25-vector -> (J_angles (3,2), J_euler (3,3), J_pos (3,3), t_blast)."""
    j_angles = p[0:6].reshape(2, 3).T
    j_euler = p[6:15].reshape(3, 3).T
    j_pos = p[15:24].reshape(3, 3).T
    return j_angles, j_euler, j_pos, p[24]


def default_stage_params(t_blast: float = 2.2 * 9.81, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """acados codegen defaults: zero Jacobians, hard-coded T_blast."""
    p = torch.zeros(cfg.NP, dtype=dtype, device=resolve_device(device))
    p[-1] = t_blast
    return p


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _unit_z(like: torch.Tensor) -> torch.Tensor:
    """(0, 0, 1) in like's dtype and device, filled on the device (a tick
    makes no tensor from host data)."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[2]


def blaster_ode(x: torch.Tensor, u: torch.Tensor, p: torch.Tensor,
                params: BlasterParams) -> torch.Tensor:
    """xdot = f(x, u, p) for one node.

    x: (17,) [p, eul, v, omega, alpha, poc]; u: (6,) [T1..T4, a1dot, a2dot];
    p: (25,) stage parameters (POC Jacobians + T_blast).
    """
    eul = x[cfg.IDX_EUL]
    v = x[cfg.IDX_V]
    omega = x[cfg.IDX_OMEGA]
    alpha = x[cfg.IDX_ALPHA]
    thrust = u[0:4]
    alpha_dot = u[4:6]

    j_angles, j_euler, j_pos, t_blast = unpack_stage_params(p)

    R = euler_zyx_to_rot(eul)
    R_gimbal = gimbal_rotation(alpha[0], alpha[1])

    # Translational dynamics: collective thrust along body z plus the
    # blast reaction along nozzle z, both rotated to world.
    total_thrust = torch.sum(thrust)
    e3 = _unit_z(x)
    f_world = R @ (e3 * total_thrust) + R @ (R_gimbal @ (e3 * t_blast))
    g_vec = torch.stack([torch.zeros_like(params.gravity),
                         torch.zeros_like(params.gravity), -params.gravity])
    v_dot = f_world / params.mass + g_vec

    # Rotational dynamics: rotor mixing and Euler's equation with
    # diagonal inertia.
    t1, t2, t3, t4 = thrust[0], thrust[1], thrust[2], thrust[3]
    moments = torch.stack([
        (t2 + t4 - t1 - t3) * params.arm_length_y,
        (-t1 - t4 + t2 + t3) * params.arm_length_x,
        (-t1 - t2 + t3 + t4) * params.yaw_coefficient,
    ])
    J = params.inertia
    omega_dot = (moments - _cross(omega, J * omega)) / J

    eul_dot = euler_rates_from_omega(eul, omega)

    # POC propagation through the frozen jet linearization.
    poc_dot = j_pos @ v + j_euler @ eul_dot + j_angles @ alpha_dot

    return torch.cat([v, eul_dot, v_dot, omega_dot, alpha_dot, poc_dot])
