"""OCP specification — the analog of the reference's AcadosOcp.

Port of `mpc_blaster_tpu/ocp/spec.py`. LINEAR_LS tracking cost with full
box bounds:

    sum_k dt * ( 0.5|x_k - yref_x,k|^2_Q + 0.5|u_k - yref_u,k|^2_R )
        + 0.5|x_N - yref_e|^2_{Q_t}

Stage costs are scaled by the shooting interval, the terminal cost is not.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mpc_blaster_tpu_torch import config as cfg


class OCPSpec(NamedTuple):
    """Per-solve problem data.

    Q: (nx, nx); R: (nu, nu); Q_t: (nx, nx)
    yref_x: (N, nx); yref_u: (N, nu); yref_e: (nx,)
    lbx/ubx: (nx,); lbu/ubu: (nu,)
    stage_params: (N, np) 25-dim POC-Jacobian parameters per stage
    dt: scalar shooting interval
    """

    Q: torch.Tensor
    R: torch.Tensor
    Q_t: torch.Tensor
    yref_x: torch.Tensor
    yref_u: torch.Tensor
    yref_e: torch.Tensor
    lbx: torch.Tensor
    ubx: torch.Tensor
    lbu: torch.Tensor
    ubu: torch.Tensor
    stage_params: torch.Tensor
    dt: torch.Tensor

    @property
    def horizon(self) -> int:
        return self.yref_x.shape[-2]


def build_spec(ocp: cfg.OCPConfig, yref=None, stage_params=None,
               dtype=torch.float32, device=None) -> OCPSpec:
    """Build an OCPSpec from config (+ optional 23-dim yref as the reference
    passes it: stage refs identical, the terminal ref is yref[:nx])."""
    N = ocp.N
    if yref is None:
        yref = np.zeros(cfg.NY)
    yref = np.asarray(yref, dtype=np.float64)
    if yref.ndim == 1:
        yref_x = np.tile(yref[:cfg.NX], (N, 1))
        yref_u = np.tile(yref[cfg.NX:], (N, 1))
        yref_e = yref[:cfg.NX]
    else:  # (N, ny) trajectory tracking
        yref_x = yref[:, :cfg.NX]
        yref_u = yref[:, cfg.NX:]
        yref_e = yref[-1, :cfg.NX]
    if stage_params is None:
        # codegen defaults: zero Jacobians + hard-coded T_blast
        t_blast = 2.2 * 9.81 if ocp.quirks.hardcode_t_blast \
            else ocp.model.blast_thruster
        stage_params = np.zeros((N, cfg.NP))
        stage_params[:, -1] = t_blast
    if isinstance(stage_params, torch.Tensor):
        stage_params = stage_params.detach().cpu().numpy()
    stage_params = np.asarray(stage_params, dtype=np.float64)
    if stage_params.ndim == 1:
        stage_params = np.tile(stage_params, (N, 1))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    return OCPSpec(
        Q=t(ocp.cost.Q()), R=t(ocp.cost.R()), Q_t=t(ocp.cost.Q_t()),
        yref_x=t(yref_x), yref_u=t(yref_u), yref_e=t(yref_e),
        lbx=t(ocp.bounds.lbx), ubx=t(ocp.bounds.ubx),
        lbu=t(ocp.bounds.lbu), ubu=t(ocp.bounds.ubu),
        stage_params=t(stage_params), dt=t(ocp.dt),
    )


def stage_cost(spec: OCPSpec, x: torch.Tensor, u: torch.Tensor,
               k: int) -> torch.Tensor:
    """dt * (0.5|x-yref|^2_Q + 0.5|u-uref|^2_R) for diagnostics."""
    ex = x - spec.yref_x[k]
    eu = u - spec.yref_u[k]
    return spec.dt * (0.5 * ex @ spec.Q @ ex + 0.5 * eu @ spec.R @ eu)


def total_cost(spec: OCPSpec, xs: torch.Tensor,
               us: torch.Tensor) -> torch.Tensor:
    """Full-trajectory objective (the controller's cost per tick)."""
    ex = xs[:-1] - spec.yref_x
    eu = us - spec.yref_u
    c = 0.5 * spec.dt * (
        torch.einsum("ki,ij,kj->", ex, spec.Q, ex)
        + torch.einsum("ki,ij,kj->", eu, spec.R, eu))
    ee = xs[-1] - spec.yref_e
    return c + 0.5 * ee @ spec.Q_t @ ee
