"""Fused component-form linearization: RK4 + forward sensitivities with
zero small matmuls.

Port of `mpc_blaster_tpu/dynamics/fastlin.py`. The BLASTER ODE is
restated with every state component as a row of a (17, L) array (or a
tuple of 17 (L,) rows), all products written out as elementwise
multiply-adds. L packs (shooting node s, tangent column j): lane
s*23 + j carries the primal for node s and the seed d/dx_j (j < 17) or
d/du_{j-17}. One `torch.func.jvp` through the RK4 of this elementwise
function yields x_next, A = dF/dx and B = dF/du for all nodes -- the same
numbers as `sqp/rti.py::_linearize_nodes` (same Butcher tableau, same
derivative mode), without the jacfwd path's small matmuls.

Plain PyTorch: the JAX version is XLA, not a Pallas kernel. It is the host
linearizer of the batched fused tick (`parallel/mesh.py`,
`backend="pallas_fused"`) and of `lin_backend="fused"`, and the plain twin
of the CUDA kernel's linearization prologue (`csrc/box_qp_ipm.cu`,
FUSE_LIN mode). Inputs may carry leading batch axes.
"""
from __future__ import annotations

import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams

NX = cfg.NX  # 17
NU = cfg.NU  # 6
_C = NX + NU  # tangent columns per shooting node


def _stack(rows, like):
    return rows if isinstance(like, tuple) else torch.stack(rows, dim=0)


def _ode_rows(X, U, P, params: BlasterParams):
    """blaster_ode with components as rows: X (17, L), U (6, L), P (25, L)
    -> Xdot (17, L); tuples of rows in give a tuple out. Pure elementwise
    ops (see `blaster.py::blaster_ode` for the vector form)."""
    phi, th, psi = X[3], X[4], X[5]
    vx, vy, vz = X[6], X[7], X[8]
    w1, w2, w3 = X[9], X[10], X[11]
    a1, a2 = X[12], X[13]
    t1, t2, t3, t4 = U[0], U[1], U[2], U[3]
    ad1, ad2 = U[4], U[5]
    tb = P[24]

    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(th), torch.sin(th)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)

    # World-from-body R = Rz(psi) Ry(th) Rx(phi), written out.
    r00 = cpsi * cth
    r01 = cpsi * sth * sphi - spsi * cphi
    r02 = cpsi * sth * cphi + spsi * sphi
    r10 = spsi * cth
    r11 = spsi * sth * sphi + cpsi * cphi
    r12 = spsi * sth * cphi - cpsi * sphi
    r20 = -sth
    r21 = cth * sphi
    r22 = cth * cphi

    # Body-frame force: collective thrust along body z + blast reaction
    # along the nozzle axis Ry(a1)Rx(a2) e3 = [s1 c2, -s2, c1 c2].
    c1, s1 = torch.cos(a1), torch.sin(a1)
    c2, s2 = torch.cos(a2), torch.sin(a2)
    t_tot = t1 + t2 + t3 + t4
    fb0 = s1 * c2 * tb
    fb1 = -s2 * tb
    fb2 = t_tot + c1 * c2 * tb
    inv_m = 1.0 / params.mass
    vdx = (r00 * fb0 + r01 * fb1 + r02 * fb2) * inv_m
    vdy = (r10 * fb0 + r11 * fb1 + r12 * fb2) * inv_m
    vdz = (r20 * fb0 + r21 * fb1 + r22 * fb2) * inv_m - params.gravity

    # Euler's equation, diagonal inertia; rotor mixing per blaster_ode.
    ly, lx, cy = (params.arm_length_y, params.arm_length_x,
                  params.yaw_coefficient)
    m0 = (t2 + t4 - t1 - t3) * ly
    m1 = (-t1 - t4 + t2 + t3) * lx
    m2 = (-t1 - t2 + t3 + t4) * cy
    j1, j2, j3 = params.inertia[0], params.inertia[1], params.inertia[2]
    wd1 = (m0 - (w2 * (j3 * w3) - w3 * (j2 * w2))) / j1
    wd2 = (m1 - (w3 * (j1 * w1) - w1 * (j3 * w3))) / j2
    wd3 = (m2 - (w1 * (j2 * w2) - w2 * (j1 * w1))) / j3

    # Attitude kinematics (closed-form E^-1).
    tth = torch.tan(th)
    phid = w1 + sphi * tth * w2 + cphi * tth * w3
    thd = cphi * w2 - sphi * w3
    psid = (sphi * w2 + cphi * w3) / cth

    # POC propagation: j_pos@v + j_euler@eul_dot + j_angles@alpha_dot with
    # the column-major 25-vector packing of `blaster.py::unpack_stage_params`
    # (j_angles[i,j] = P[3j+i], j_euler[i,j] = P[6+3j+i], j_pos = P[15+3j+i]).
    euld = (phid, thd, psid)
    vv = (vx, vy, vz)
    aa = (ad1, ad2)
    poc = []
    for i in range(3):
        acc = P[15 + i] * vv[0] + P[18 + i] * vv[1] + P[21 + i] * vv[2]
        acc = acc + P[6 + i] * euld[0] + P[9 + i] * euld[1] \
            + P[12 + i] * euld[2]
        acc = acc + P[i] * aa[0] + P[3 + i] * aa[1]
        poc.append(acc)

    rows = (vx, vy, vz,
            phid, thd, psid,
            vdx, vdy, vdz,
            wd1, wd2, wd3,
            ad1, ad2,
            poc[0], poc[1], poc[2])
    return _stack(rows, X)


def _ode_rows_dist(X, U, P, params: BlasterParams):
    """Disturbance-augmented BLASTER rows (the offset-free prediction
    model): the observer's force and torque acceleration estimates ride in
    six extra stage-parameter rows (P[25:28] on v_dot, P[28:31] on
    omega_dot)."""
    Xd = _ode_rows(X, U, P, params)
    if isinstance(Xd, tuple):
        return (Xd[:6] + tuple(Xd[6 + i] + P[25 + i] for i in range(6))
                + Xd[12:])
    return torch.cat([Xd[0:6], Xd[6:9] + P[25:28], Xd[9:12] + P[28:31],
                      Xd[12:]], dim=0)


def _quad13_rows(X, U, P, params: BlasterParams):
    """`models/quad13.py::quad13_ode` with components as rows: X (13, L),
    U (4, L) -> Xdot (13, L); P unused. Hamilton-product q_dot with the raw
    state quaternion and the R(q)e3 thrust column of the normalized one."""
    del P
    qw, qx, qy, qz = X[3], X[4], X[5], X[6]
    vx, vy, vz = X[7], X[8], X[9]
    w1, w2, w3 = X[10], X[11], X[12]
    t1, t2, t3, t4 = U[0], U[1], U[2], U[3]

    qn = torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    iw, ix, iy, iz = qw / qn, qx / qn, qy / qn, qz / qn

    # R(qn) e3 -- third column of quat_to_rot
    r02 = 2.0 * (ix * iz + iw * iy)
    r12 = 2.0 * (iy * iz - iw * ix)
    r22 = 2.0 * (iw * iw + iz * iz) - 1.0
    t_tot = (t1 + t2 + t3 + t4) / params.mass
    vdx = r02 * t_tot
    vdy = r12 * t_tot
    vdz = r22 * t_tot - params.gravity

    qdw = 0.5 * (-qx * w1 - qy * w2 - qz * w3)
    qdx = 0.5 * (qw * w1 + qy * w3 - qz * w2)
    qdy = 0.5 * (qw * w2 - qx * w3 + qz * w1)
    qdz = 0.5 * (qw * w3 + qx * w2 - qy * w1)

    ly, lx, cy = (params.arm_length_y, params.arm_length_x,
                  params.yaw_coefficient)
    m0 = (t2 + t4 - t1 - t3) * ly
    m1 = (-t1 - t4 + t2 + t3) * lx
    m2 = (-t1 - t2 + t3 + t4) * cy
    j1, j2, j3 = params.inertia[0], params.inertia[1], params.inertia[2]
    wd1 = (m0 - (w2 * (j3 * w3) - w3 * (j2 * w2))) / j1
    wd2 = (m1 - (w3 * (j1 * w1) - w1 * (j3 * w3))) / j2
    wd3 = (m2 - (w1 * (j2 * w2) - w2 * (j1 * w1))) / j3

    rows = (vx, vy, vz,
            qdw, qdx, qdy, qdz,
            vdx, vdy, vdz,
            wd1, wd2, wd3)
    return _stack(rows, X)


# Rows-form ODE families, by the name `sqp/rti.py::fused_dyn_statics`
# carries. All three share the 8 physical constants of a BlasterParams.
FAMILIES = {
    "blaster": _ode_rows,
    "blaster_dist": _ode_rows_dist,
    "quad13": _quad13_rows,
}


def _rk4_rows(X, U, P, params, dt, num_steps, ode=_ode_rows):
    """Classic RK4 with `num_steps` substeps in the rows layout. X may be a
    stacked (nx, L) tensor or a tuple of (L,) rows (then U and P are tuples
    too, and the result is a tuple)."""
    h = dt / num_steps
    if isinstance(X, tuple):
        for _ in range(num_steps):
            k1 = ode(X, U, P, params)
            X2 = tuple(x + (0.5 * h) * k for x, k in zip(X, k1))
            k2 = ode(X2, U, P, params)
            X3 = tuple(x + (0.5 * h) * k for x, k in zip(X, k2))
            k3 = ode(X3, U, P, params)
            X4 = tuple(x + h * k for x, k in zip(X, k3))
            k4 = ode(X4, U, P, params)
            X = tuple(x + (h / 6.0) * (a + 2.0 * b + 2.0 * c + d)
                      for x, a, b, c, d in zip(X, k1, k2, k3, k4))
        return X
    for _ in range(num_steps):
        k1 = ode(X, U, P, params)
        k2 = ode(X + (0.5 * h) * k1, U, P, params)
        k3 = ode(X + (0.5 * h) * k2, U, P, params)
        k4 = ode(X + h * k3, U, P, params)
        X = X + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return X


def fast_linearize(xbar: torch.Tensor, ubar: torch.Tensor,
                   stage_params: torch.Tensor, params: BlasterParams,
                   dt: float, num_steps: int = 1, family: str = "blaster"):
    """(x_next, A, B) for all shooting nodes -- drop-in for
    `sqp/rti.py::_linearize_nodes`: xbar (..., N+1, nx), ubar (..., N, nu),
    stage_params (N, np) or (..., N, np) -> x_next (..., N, nx),
    A (..., N, nx, nx), B (..., N, nx, nu). One jvp through the tuple-form
    RK4 over the lanes (batch, node, column)."""
    n = ubar.shape[-2]
    nx, nu = xbar.shape[-1], ubar.shape[-1]
    nc = nx + nu
    ode = FAMILIES[family]
    xs = xbar[..., :-1, :]

    def lanes(a, j):  # column j of every node, repeated over its nc lanes
        return a[..., j].repeat_interleave(nc, dim=-1)

    x_re = tuple(lanes(xs, j) for j in range(nx))
    u_re = tuple(lanes(ubar, j) for j in range(nu))
    p_re = tuple(lanes(stage_params, j)
                 for j in range(stage_params.shape[-1]))
    col = torch.arange(nc, device=xbar.device).repeat(n)
    lead = xs.shape[:-2]
    x_du = tuple((col == j).to(xbar.dtype).expand(*lead, n * nc)
                 for j in range(nx))
    u_du = tuple((col == nx + j).to(xbar.dtype).expand(*lead, n * nc)
                 for j in range(nu))

    def f(xr, ur):
        return _rk4_rows(xr, ur, p_re, params, dt, num_steps, ode=ode)

    y, yd = torch.func.jvp(f, (x_re, u_re), (x_du, u_du))
    y = torch.stack(y, dim=-2).unflatten(-1, (n, nc))    # (..., nx, n, nc)
    yd = torch.stack(yd, dim=-2).unflatten(-1, (n, nc))
    x_next = y[..., 0].transpose(-1, -2)                 # (..., n, nx)
    ab = yd.movedim(-3, -2)                              # (..., n, nx, nc)
    return x_next, ab[..., :nx], ab[..., nx:]


def make_fused_linearizer(ocp: cfg.OCPConfig, params: BlasterParams,
                          num_steps: int = 1, family: str = "blaster"):
    """Closure matching the `linearizer` hook of `sqp/rti.py::build_qp`."""
    def lin(xbar, ubar, stage_params):
        return fast_linearize(xbar, ubar, stage_params, params, ocp.dt,
                              num_steps, family=family)
    return lin
