"""Configuration for the BLASTER MPC framework (the port's own copy).

The port's copy of `mpc_blaster_tpu/config.py`: the same names, fields,
defaults and presets, `deployed_solver` included ("safe" and "fast": cold
one-launch fused ticks; "fastest": the 3-iteration shifted primal-recentred
warm chain under the divergence watchdog, run with
`make_closed_loop(..., warm_start=True)`). The port imports nothing of the
JAX package, so it keeps this copy; `tests/test_torch_closedloop.py` holds
every preset and profile against the original field by field. Instances of
the two modules' dataclasses are different classes: compare them by
fields, never with `==`.

The reference hard-codes every constant and duplicates them with *divergent*
values across its three entry points (see e.g. mass 10 in
`src/scripts/blastermodel.py:296` vs mass 9.0 in
`src/scripts/simulation_blaster.py:12`; thrust upper bound 6.5 vs 65 at
`blastermodel.py:314` vs `simulation_blaster.py:30`). Here every entry point's
exact numbers live in a named preset built from one dataclass hierarchy.

Presets:
  - ``simulation_preset()``  reproduces `src/scripts/simulation_blaster.py:12-48`
  - ``flight_preset()``      reproduces `src/scripts/mavros_blaster_sim.py:15-61`
  - ``smoke_preset()``       reproduces `src/scripts/blastermodel.py:294-315`
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# State layout (nx=17), matching the reference packing order
# (`src/scripts/blastermodel.py:171-183`):
#   [0:3]   p        world position (ENU)
#   [3:6]   eul      ZYX Euler angles (phi, theta, psi)
#   [6:9]   v        world linear velocity
#   [9:12]  omega    body angular rates
#   [12:14] alpha    gimbal angles (alpha1 about y, alpha2 about x)
#   [14:17] poc      water-jet point of contact (world)
# Control layout (nu=6) (`blastermodel.py:184-190`):
#   [0:4]   T1..T4   rotor thrusts
#   [4:6]   alpha1_dot, alpha2_dot
# Stage parameters (np=25) (`blastermodel.py:203-210`, column-major packing):
#   [0:6]   vec(J_angles 3x2)
#   [6:15]  vec(J_euler 3x3)
#   [15:24] vec(J_p 3x3)
#   [24]    T_blast
NX = 17
NU = 6
NP = 25
NY = NX + NU
IDX_P = slice(0, 3)
IDX_EUL = slice(3, 6)
IDX_V = slice(6, 9)
IDX_OMEGA = slice(9, 12)
IDX_ALPHA = slice(12, 14)
IDX_POC = slice(14, 17)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Physical parameters of the BLASTER vehicle.

    Defaults are the flight/simulation vehicle (`simulation_blaster.py:12-22`).
    """

    mass: float = 9.0
    inertia_diag: Tuple[float, float, float] = (0.50781, 0.47314, 0.72975)
    arm_length_x: float = 0.3434
    arm_length_y: float = 0.3475
    yaw_coefficient: float = 0.03
    blast_thruster: float = 2.2 * 9.81
    gravity: float = 9.81


@dataclasses.dataclass(frozen=True)
class CostConfig:
    """LINEAR_LS cost: ||Vx x + Vu u - yref||^2_W, W = blkdiag(Q, R).

    ``scale_by_dt`` mirrors the acados default of scaling stage costs by the
    shooting-interval length (terminal cost unscaled); the reference relies on
    that default (JSON `time_steps`, `cost` blocks).
    """

    q_diag: Tuple[float, ...]
    r_diag: Tuple[float, ...]
    qt_diag: Tuple[float, ...]
    scale_by_dt: bool = True

    def Q(self) -> np.ndarray:
        return np.diag(np.asarray(self.q_diag, dtype=np.float64))

    def R(self) -> np.ndarray:
        return np.diag(np.asarray(self.r_diag, dtype=np.float64))

    def Q_t(self) -> np.ndarray:
        return np.diag(np.asarray(self.qt_diag, dtype=np.float64))


@dataclasses.dataclass(frozen=True)
class BoundsConfig:
    """Box bounds on all states and controls (`blastermodel.py:261-270`)."""

    lbx: Tuple[float, ...]
    ubx: Tuple[float, ...]
    lbu: Tuple[float, ...]
    ubu: Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """SQP-RTI / interior-point solver knobs.

    The reference fixes SQP_RTI + PARTIAL_CONDENSING_HPIPM with
    `qp_solver_iter_max=500` and NLP tolerances 1e-6
    (`blastermodel.py:272-287`). Here the iteration budget is static:
    ``ipm_iters`` interior-point iterations are always run (in the
    kernel's loop, or the eager solvers' Python loop), and the best
    iterate by KKT merit is returned, so extra iterations past
    convergence are harmless (see `qp/ipm.py`).

    The ``tol_*`` fields are the acceptance thresholds of the acados JSON's
    `nlp_solver_tol_{stat,eq,ineq,comp} = 1e-6`: they do NOT stop the
    (static-budget) iteration; they define the per-solve ``converged`` /
    health flag in `RTIDiagnostics` (`sqp/rti.py::diag_converged`) — the
    failure-detection surface the reference computes but ignores
    (`simulation_blaster.py:80`, SURVEY.md §5).
    """

    ipm_iters: int = 12
    ipm_mu0: float = 1e-1
    ipm_alpha_frac: float = 0.995   # fraction-to-boundary
    ipm_reg: float = 1e-8           # Riccati regularization
    sqp_iters: int = 1              # 1 == RTI semantics (SQP_RTI)
    # QP backend: "riccati" = full-horizon Riccati IPM (qp/ipm.py, HPIPM
    # cond_N=N analog — the reference's actual setting); "condensed" =
    # partial condensing with block size cond_M (qp/condense.py, the
    # HPIPM cond_N = N/cond_M capability: shorter sequential chain,
    # denser matmuls).
    # "pallas" = the box-QP IPM kernel K1, one launch for the whole IPM
    # (csrc/box_qp_ipm.cu via ops/box_qp_ipm.py; the twin on the CPU);
    # "pallas_fused" = the SINGLE-KERNEL RTI tick: RK4 linearization runs
    # inside the IPM kernel too (B=1 BLASTER latency path; needs
    # dyn_statics — make_rti_step/closed_loop wire it automatically).
    qp_backend: str = "riccati"
    cond_M: int = 5
    # Inner Newton-system solver of the Riccati IPM: "scan" (sequential
    # per-stage sweeps, best batched throughput), "pscan" (O(log N)
    # associative-scan factor+solve, latency/sharded-horizon oriented) or
    # "hybrid" (sequential factorization + parallel-scan RHS solves).
    riccati: str = "scan"
    # Linearization backend: "jacfwd" = vmapped jax.jacfwd of the RK4 map
    # (acados forward-sensitivity ERK analog); "fused" = component-form
    # RK4+jvp with zero small matmuls (`dynamics/fastlin.py`) — same
    # numbers, fewer XLA ops, built for the B=1 latency loop where the
    # jacfwd path is dispatch-bound.
    lin_backend: str = "jacfwd"
    # Pallas kernel HBM-streaming overrides (None = auto by horizon), kept
    # so that configs compare field by field with the JAX package's. The
    # CUDA kernel has one layout for every N and reads neither (see
    # ops/box_qp_ipm.py::box_qp_solve).
    pallas_stream_p: bool | None = None
    pallas_stream_big: bool | None = None
    # Warm-start conditioning for rti_step_warm chains (see
    # qp/ipm.py::warm_start_recenter): "full" passes slacks+duals as-is
    # (HPIPM warm_start=1), "primal" re-centers duals at mu0/s,
    # "centrality" clips complementarity pairs into [0.1, 10]*mu0.
    # warm_shift additionally time-shifts the carried iterate and
    # slack/dual state one stage per tick (the classical RTI shift).
    warm_mode: str = "full"
    warm_shift: bool = False
    # Online warm-chain divergence watchdog (r4,
    # sqp/rti.py::rti_step_warm_guarded): warm loops recompute a tick
    # cold on nonfinite output, a KKT-eq jump past max(30 * EMA, 0.5),
    # or iterate box violation > 0.25 (early-degradation signal), then
    # HOLD the chain cold for 10 ticks (hysteresis — a chain that
    # re-degrades every tick needs the carried-iterate cold behavior,
    # not a per-tick restart; measured). Costs extra solves only around
    # tripped ticks; makes the "fastest" profile safely defaultable
    # (the altitude-step failure class is caught online instead of by
    # offline stress gating alone).
    warm_watchdog: bool = False
    # QP-ONLY control-Hessian floor (r5): per-control minimum diagonal of
    # the R used to build the QP's Gauss-Newton Hessian. The QP GRADIENT
    # keeps the true R, so stationary points of the reported cost are
    # unchanged — this is pure proximal (Levenberg-style) damping of
    # weakly-determined control subspaces. Motivation (measured r4):
    # under the sim preset's R_swivel=1e-5 the gimbal's lateral
    # blast-force channel is a near-free actuator, and offset-free wind
    # compensation excites it into a +-1 m limit cycle even with an
    # EXACT disturbance estimate; flooring the two swivel-rate Hessian
    # entries damps the per-tick du proposals in that flat subspace and
    # the same loop settles to centimeters (tests/test_scenarios.py).
    # None (default) = off: every existing loop is bit-unchanged.
    qp_r_floor: Optional[Tuple[float, ...]] = None
    tol_stat: float = 1e-6
    tol_eq: float = 1e-6
    tol_ineq: float = 1e-6
    tol_comp: float = 1e-6


@dataclasses.dataclass(frozen=True)
class QuirkConfig:
    """Reference behaviors that are bugs/quirks, reproducible as options.

    - ``hardcode_t_blast``: `generateController` overrides the constructor's
      blastThruster with 2.2*9.81 in the default stage parameters
      (`blastermodel.py:280-281`).
    - ``zero_poc_jacobians``: the flight node never sets stage parameters, so
      the POC Jacobians stay at their zero codegen defaults and poc_dot == 0
      in flight (`mavros_blaster_sim.py:76-83`, SURVEY.md §3.4).
    - ``constant_poc_jacobians``: the offline sim computes POC Jacobians once
      before the loop and never re-linearizes (`simulation_blaster.py:37-39`).
    """

    hardcode_t_blast: bool = True
    zero_poc_jacobians: bool = False
    constant_poc_jacobians: bool = True


@dataclasses.dataclass(frozen=True)
class OCPConfig:
    """Full OCP problem definition (dims + costs + bounds + solver)."""

    model: ModelConfig
    cost: CostConfig
    bounds: BoundsConfig
    N: int = 60
    Tf: float = 2.0
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    quirks: QuirkConfig = dataclasses.field(default_factory=QuirkConfig)

    @property
    def dt(self) -> float:
        return self.Tf / self.N


@dataclasses.dataclass(frozen=True)
class PocSolverConfig:
    """Water-jet POC solver (`Jacobian_POC_Solver.__init__`:20-51).

    stream_velocity: nozzle exit speed (jet leaves along -z of nozzle frame).
    drag: the reference's scalar M_c linear drag coefficient.
    newton_iters: static Newton budget for time-of-impact (the reference
    iterates until |z(T)|<1e-3; ~3-6 iterations in practice).
    """

    stream_velocity: float = 150.0
    drag: float = 1.0
    newton_iters: int = 12
    tol: float = 1e-3


@dataclasses.dataclass(frozen=True)
class ClosedLoopConfig:
    """Closed-loop run settings (`simulation_blaster.py:43-56`)."""

    n_steps: int = 500
    x0: Tuple[float, ...] = tuple([0.0] * NX)
    yref: Tuple[float, ...] = tuple([0.0] * NY)


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    ocp: OCPConfig
    poc: PocSolverConfig
    loop: ClosedLoopConfig


def _bounds_sim() -> BoundsConfig:
    # simulation_blaster.py:28-30
    return BoundsConfig(
        lbx=(-1.5, -1.5, 0.0, -0.174532925, -0.174532925, -0.349066,
             -1.0, -1.0, -1.0, -0.0872665, -0.0872665, -0.0872665,
             -0.174532925, -0.523599, -1.5, -1.5, -2.5),
        ubx=(1.5, 1.5, 5.0, 0.174532925, 0.174532925, 0.349066,
             1.0, 1.0, 1.0, 0.0872665, 0.0872665, 0.0872665,
             1.22173, 0.523599, 1.5, 1.5, 2.5),
        lbu=(0.0, 0.0, 0.0, 0.0, -0.0872665, -0.0872665),
        ubu=(65.0, 65.0, 65.0, 65.0, 0.0872665, 0.0872665),
    )


def simulation_preset() -> Preset:
    """The offline closed-loop sim: `simulation_blaster.py:12-48`."""
    ocp = OCPConfig(
        model=ModelConfig(mass=9.0, blast_thruster=2.2 * 9.81),
        cost=CostConfig(
            q_diag=(1e3, 1e3, 1e3, 1e3, 1e3, 1e3,
                    0.5e1, 0.5e1, 0.5e1, 1e1, 1e1, 1e1,
                    1e-2, 1e-2, 1e3, 1e3, 1e3),
            r_diag=(5e-2, 5e-2, 5e-2, 5e-2, 1e-5, 1e-5),
            qt_diag=(1e4, 1e4, 1e4, 1e4, 1e4, 1e4,
                     0.5e2, 0.5e2, 0.5e2, 1e2, 1e2, 1e2,
                     1e-1, 1e-1, 1e4, 1e4, 1e4),
        ),
        bounds=_bounds_sim(),
        N=60,
        Tf=2.0,
    )
    yref = (0.0, 0.0, 3.5) + (0.0,) * 11 + (0.2, 0.0, 0.0) + (0.0,) * 6
    return Preset(
        name="simulation",
        ocp=ocp,
        poc=PocSolverConfig(stream_velocity=150.0, drag=1.0),
        loop=ClosedLoopConfig(n_steps=500, yref=yref),
    )


def flight_preset() -> Preset:
    """The MAVROS flight node: `mavros_blaster_sim.py:15-61`."""
    bounds = BoundsConfig(
        lbx=(-1.5, -1.5, 0.0, -0.174532925, -0.174532925, -0.349066,
             -0.5, -0.5, -0.5, -0.0872665, -0.0872665, -0.0872665,
             -0.174532925, -0.523599, -1.5, -1.5, -2.5),
        ubx=(1.5, 1.5, 5.0, 0.174532925, 0.174532925, 0.349066,
             0.4, 0.5, 1.0, 0.0872665, 0.0872665, 0.0872665,
             1.22173, 0.523599, 1.5, 1.5, 2.5),
        lbu=(0.0, 0.0, 0.0, 0.0, -0.0872665, -0.0872665),
        ubu=(65.0, 65.0, 65.0, 65.0, 0.0872665, 0.0872665),
    )
    ocp = OCPConfig(
        model=ModelConfig(mass=9.0, blast_thruster=2.2),
        cost=CostConfig(
            q_diag=(1e2, 1e2, 1e2, 1e2, 1e2, 1e2,
                    0.5e1, 0.5e1, 0.5e1, 1e1, 1e1, 1e1,
                    1e-2, 1e-2, 1.0, 1.0, 1.0),
            r_diag=(5e-2, 5e-2, 5e-2, 5e-2, 1e1, 1e1),
            qt_diag=(1e3, 1e3, 1e3, 1e3, 1e3, 1e3,
                     0.5e2, 0.5e2, 0.5e2, 1e2, 1e2, 1e2,
                     1e-1, 1e-1, 10.0, 10.0, 10.0),
        ),
        bounds=bounds,
        N=30,
        Tf=1.0,
        quirks=QuirkConfig(hardcode_t_blast=True, zero_poc_jacobians=True),
    )
    yref = (0.5, 1.0, 3.5) + (0.0,) * 20
    return Preset(
        name="flight",
        ocp=ocp,
        poc=PocSolverConfig(),
        loop=ClosedLoopConfig(n_steps=750, yref=yref),
    )


def smoke_preset() -> Preset:
    """The build-sanity `__main__` of the model file: `blastermodel.py:294-315`."""
    bounds = BoundsConfig(
        lbx=(-1.5, -1.5, 0.0, -0.174532925, -0.174532925, -0.349066,
             -0.5, -0.5, -0.5, -0.0872665, -0.0872665, -0.0872665,
             -0.174532925, -0.523599, -1.5, -1.5, -2.5),
        ubx=(1.5, 1.5, 2.5, 0.174532925, 0.174532925, 0.349066,
             0.5, 0.5, 0.5, 0.0872665, 0.0872665, 0.0872665,
             1.22173, 0.523599, 1.5, 1.5, 2.5),
        lbu=(0.0, 0.0, 0.0, 0.0, -0.0872665, -0.0872665),
        ubu=(6.5, 6.5, 6.5, 6.5, 0.0872665, 0.0872665),
    )
    ocp = OCPConfig(
        model=ModelConfig(mass=10.0, blast_thruster=2.2),
        cost=CostConfig(
            q_diag=(10e2, 10e2, 10e2, 1e2, 1e2, 1e-1,
                    5e1, 5e1, 5e1, 1e1, 1e1, 1e1,
                    1e-2, 1e-2, 10e2, 10e2, 10e2),
            r_diag=(3e1, 3e1, 3e1, 3e1, 1e1, 1e1),
            qt_diag=(10e3, 10e3, 10e3, 1e3, 1e3, 1.0,
                     5e2, 5e2, 5e2, 1e2, 1e2, 1e2,
                     1e-1, 1e-1, 10e3, 10e3, 10e3),
        ),
        bounds=bounds,
        N=30,
        Tf=1.0,
    )
    return Preset(
        name="smoke",
        ocp=ocp,
        poc=PocSolverConfig(),
        loop=ClosedLoopConfig(n_steps=50),
    )


def deployed_solver(profile: str = "safe") -> SolverConfig:
    """Deployment solver profiles (the JAX package's bench rows at N=20;
    all pass the altitude-step transient stress and match or beat the
    12-iteration figure-8 error). All three run the single-launch fused
    RTI tick (qp_backend="pallas_fused": the RK4 linearization inside
    the IPM kernel, `csrc/box_qp_ipm.cu` in its FUSE_LIN mode):

    - "safe":    cold 6-iteration fused ticks. The most conservative
                 profile; mirrors the reference's HPIPM
                 `qp_solver_warm_start=0` with generous iterations.
    - "fast":    cold 4-iteration fused ticks.
    - "fastest": 3-iteration shifted primal-recentered warm chain.
                 Requires a warm loop (closed_loop / make_tracking_loop
                 with warm_start=True) so the slack/dual state threads
                 between ticks, and carries the online divergence
                 watchdog (warm_watchdog=True,
                 `sqp/rti.py::rti_step_warm_guarded`): a tick whose
                 KKT-eq residual jumps past 30x the chain's running
                 level is recomputed cold in place.

    On the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 5,
    `chip_smoke.py`): the "safe" closed loop at N=60 takes 9.69 ms a
    tick and bench.py's fig8_rt6f loop (the "safe" budget at N=20) 6.05
    ms; "fastest" at N=60 takes 10.2-11.2 ms a tick (the tick and the
    watchdog's redo launch). "fast" has not been timed as a loop.
    """
    base = dict(qp_backend="pallas_fused", lin_backend="fused")
    if profile == "safe":
        return SolverConfig(ipm_iters=6, **base)
    if profile == "fast":
        return SolverConfig(ipm_iters=4, **base)
    if profile == "fastest":
        return SolverConfig(ipm_iters=3, warm_mode="primal",
                            warm_shift=True, warm_watchdog=True, **base)
    raise ValueError(f"unknown deployment profile {profile!r} "
                     "(expected 'safe', 'fast' or 'fastest')")


PRESETS = {
    "simulation": simulation_preset,
    "flight": flight_preset,
    "smoke": smoke_preset,
}


def get_preset(name: str) -> Preset:
    return PRESETS[name]()
