"""LQR terminal-cost synthesis: Q_t as the infinite-horizon cost-to-go.

Port of `mpc_blaster_tpu/ocp/terminal.py`. The reference's terminal
weights are a 10x scaling of the stage weights, not a cost-to-go, and
short horizons with such a terminal cost can be closed-loop unstable even
when every QP is solved accurately (the JAX module's docstring has the
measurements). With the unconstrained infinite-horizon LQR cost-to-go at
the target equilibrium as the terminal cost, the finite-horizon MPC value
function is a Lyapunov function wherever the tail is constraint-inactive.

Runs at set-up time on the host: the discrete algebraic Riccati equation
in float64 through scipy, on the discrete dynamics linearized in float32
by the solver's own component-form linearizer (`dynamics/fastlin.py`).
"""
from __future__ import annotations

import numpy as np
import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.device import resolve_device
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams
from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec


def _np64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


def hover_equilibrium(ocp: cfg.OCPConfig, spec: OCPSpec):
    """(x_eq, u_eq) of the hover trim at the spec's position target: the
    blast thruster (stage parameter 24) pushes along body +z at gimbal
    zero, so the rotor trim is (m g - T_blast) / 4 each."""
    x_eq = np.zeros(cfg.NX)
    x_eq[0:3] = _np64(spec.yref_x[0, 0:3])
    x_eq[14:17] = _np64(spec.yref_x[0, 14:17]) * 0.0  # poc free
    tb = float(spec.stage_params[0, -1])
    t_each = (ocp.model.mass * ocp.model.gravity - tb) / 4.0
    u_eq = np.zeros(cfg.NU)
    u_eq[0:4] = t_each
    return x_eq, u_eq


def lqr_terminal_weight(ocp: cfg.OCPConfig, spec: OCPSpec, x_eq=None,
                        u_eq=None, drop=None, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """The DARE cost-to-go at the hover equilibrium as a (nx, nx) Q_t.

    Linearizes the discrete dynamics at (x_eq, u_eq) with the solver's
    RK4 + jvp linearizer (float32, as the JAX module does), solves the
    DARE with the dt-scaled stage weights (dt Q, dt R, the scaling
    `build_qp` gives the stage costs, so P is in the units of the
    unscaled terminal slot) in float64, and returns Q_t on `device`
    (default: the spec's device).

    `drop`: state indices kept out of the DARE (at the preset's terminal
    diagonal). Default: the POC rows 14:17 when the spec's POC Jacobians
    are all zero (then poc_{k+1} = poc_k is an uncontrollable unit-circle
    mode with nonzero cost and the DARE has no solution).

    Use: ``spec = spec._replace(Q_t=lqr_terminal_weight(ocp, spec))``.
    """
    import scipy.linalg

    if x_eq is None or u_eq is None:
        x_eq_d, u_eq_d = hover_equilibrium(ocp, spec)
        x_eq = x_eq_d if x_eq is None else _np64(x_eq)
        u_eq = u_eq_d if u_eq is None else _np64(u_eq)
    if drop is None:
        j_rows = _np64(spec.stage_params[0, :24])
        drop = list(range(14, cfg.NX)) if not np.any(j_rows) else []

    params = BlasterParams.from_config(ocp.model, torch.float32, "cpu")
    xb = torch.as_tensor(np.tile(_np64(x_eq), (2, 1)), dtype=torch.float32)
    ub = torch.as_tensor(_np64(u_eq)[None], dtype=torch.float32)
    sp = torch.as_tensor(_np64(spec.stage_params[:1]), dtype=torch.float32)
    _, A, B = fast_linearize(xb, ub, sp, params, ocp.dt, 1)
    A = A[0].numpy().astype(np.float64)
    B = B[0].numpy().astype(np.float64)

    keep = [i for i in range(cfg.NX) if i not in set(drop)]
    Ak = A[np.ix_(keep, keep)]
    Bk = B[keep]
    dtw = float(spec.dt)
    Qk = dtw * _np64(spec.Q)[np.ix_(keep, keep)]
    Rk = dtw * _np64(spec.R)
    P = scipy.linalg.solve_discrete_are(Ak, Bk, Qk, Rk)
    P = 0.5 * (P + P.T)
    Qt = _np64(spec.Q_t).copy()
    Qt[np.ix_(keep, keep)] = P
    return torch.as_tensor(Qt, dtype=dtype,
                           device=resolve_device(device, spec.Q))
