"""Scenario batching of the RTI tick on one device.

Port of `mpc_blaster_tpu/parallel/mesh.py::batched_rti_step` with its
three backends, and of `batched_rti_step_per_scenario_spec`:

  - "xla" (the default): the tick of `make_rti_step(ocp)` over the batch
    (the JAX package vmaps it), on the solver's own QP backend. With the
    presets' `qp_backend="riccati"` that is `build_qp` for every scenario
    at once and the Riccati IPM of `qp/ipm.py` on its leading batch axes
    (eager PyTorch, no kernel of ours: launch-bound on the card); a
    "pallas" solver builds the same QPs and solves them with one launch
    of the box-QP IPM kernel; a "pallas_fused" solver (every
    `config.deployed_solver` profile) runs the one-launch tick over the
    batch: linearization, assembly and solve of all B problems in one
    launch of the fuse_lin kernel (`sqp/rti.py::fused_qp_solve_batched`);
  - "pallas": the QP assembly runs for every scenario at once
    (`torch.func.vmap` of `build_qp` with the `lin_backend` linearizer),
    then one launch of the box-QP IPM kernel solves the whole batch;
  - "pallas_fused": the host runs only the component-form linearizer
    (`dynamics/fastlin.py::fast_linearize`, batched); cost gradients,
    delta bounds, dx0, the IPM solve and the iterate update run in one
    launch of the fuse_cost kernel (`ops/box_qp_ipm.py::
    batched_fused_tick`).

`batched_rti_step_per_scenario_spec` is the "xla" tick with one spec per
scenario (targets and gains sweeps): every spec field carries the leading
batch axis. `batched_rti_step` takes a shared spec: no field carries it.
Each refuses the other form. `batched_tick`, which both run (and the
sweeps of `sim/scenarios.py` with per-scenario targets and stage
parameters but shared gains), takes either form field by field.

Scale-out (`make_mesh`, `sharded_rti_step`, `sharded_sweep`): the JAX
package `shard_map`s the batched tick over a 1-D "dp" mesh of chips, each
scenario's solve local to its chip and only the sweep's reductions (a
pmean, a pmax) crossing chips. Here a `Mesh` is a list of devices and an
axis name; the batch is split into one contiguous shard per mesh entry,
each shard runs `batched_tick` on its device (so a kernel-backed solver
makes one launch per shard and tick), and the reductions run over the
shards and then, where a `torch.distributed` process group is up
(`parallel/distributed.py`), as `all_reduce` over the ranks. A mesh may
name one device several times (the CPU tests' shards).

A mesh whose axis is "hp" (`make_mesh(n, axis="hp")`) shards the stage
axis of one QP instead, as the JAX package's sequence parallelism does:
the `mesh=` of `qp/pscan.py`'s solves and of `qp/ipm.py::box_qp_solve`
splits the horizon into one contiguous chunk of stages per mesh entry
(and per rank), and the scans, the reductions over the stages and the
rows where chunks meet cross the chunks (`qp/horizon.py`). The batched
ticks here keep the "dp" axis.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.func import vmap

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.device import resolve_device
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec
from mpc_blaster_tpu_torch.sqp.rti import (RTIDiagnostics, RTIState,
                                           _bound_violation,
                                           _check_backend,
                                           build_qp, fused_dyn_statics,
                                           fused_qp_solve_batched,
                                           make_linearizer, qp_hessian_R,
                                           solve_batched_qp,
                                           solve_qp_backend,
                                           spec_batch_dims)
from mpc_blaster_tpu_torch.utils import capture


def batched_rti_step(ocp: cfg.OCPConfig, dtype=torch.float32,
                     jit: bool = True, backend: str = "xla", device=None):
    """The RTI tick over a scenario batch, on `device` (default: the card,
    `device.py`).

    Returns step(spec, states, x0s) -> (u0s, states, diags); `spec` is
    shared (no field with a batch axis: `batched_rti_step_per_scenario_spec`
    takes one spec per scenario), states/x0s carry a leading batch axis. `backend="xla"` runs the tick
    of `make_rti_step(ocp)` over the batch (the module docstring),
    `backend="pallas"` solves the host-built QPs with the box-QP IPM
    kernel, `backend="pallas_fused"` runs the fuse_cost kernel. With `jit`
    the step is a `utils/capture.py` runner (a CUDA graph per shape on the
    card, the buffer handling alone on the CPU), as the JAX package jits
    it; `jit=False` returns the eager step.
    """
    device = resolve_device(device)
    if backend == "xla":
        step = _batched_tick(ocp, dtype, device, per_scenario=False)
    elif backend == "pallas":
        step = _batched_tick(_with_backend(ocp, "pallas"), dtype, device,
                             per_scenario=False)
    elif backend == "pallas_fused":
        step = _batched_rti_step_pallas_fused(ocp, dtype=dtype,
                                              device=device)
    else:
        raise ValueError(f"unknown batched backend {backend!r}")
    return capture.jit(step) if jit else step


def batched_rti_step_per_scenario_spec(ocp: cfg.OCPConfig,
                                       dtype=torch.float32,
                                       jit: bool = True, device=None):
    """Like `batched_rti_step` (the "xla" tick), with one OCPSpec per
    scenario: every spec field carries the leading batch axis (targets and
    gains sweeps). On the solver's backend: "riccati" builds the QPs
    under `vmap` and runs the Riccati IPM on the batch, "pallas" builds
    them and makes one launch of the box-QP IPM kernel, "pallas_fused"
    makes one launch of the fuse_lin kernel. A spec field without the
    batch axis is refused (`batched_rti_step` takes a shared spec). `jit`
    as in `batched_rti_step`."""
    step = _batched_tick(ocp, dtype, resolve_device(device),
                         per_scenario=True)
    return capture.jit(step) if jit else step


def _with_backend(ocp: cfg.OCPConfig, backend: str) -> cfg.OCPConfig:
    return dataclasses.replace(ocp, solver=dataclasses.replace(
        ocp.solver, qp_backend=backend))


def _batched_diag(spec, sol, new_states) -> RTIDiagnostics:
    return RTIDiagnostics(
        qp_kkt_stat=sol.kkt_stat, qp_kkt_eq=sol.kkt_eq, qp_mu=sol.mu,
        step_norm_x=sol.dx.abs().amax((1, 2)),
        step_norm_u=sol.du.abs().amax((1, 2)),
        bound_viol=_bound_violation(spec, new_states))


def _batched_tick(ocp: cfg.OCPConfig, dtype, device, per_scenario: bool):
    """`make_rti_step(ocp)`'s tick over a batch (the nominal model), its
    spec per scenario (every field with the batch axis) or shared (none)."""
    params = BlasterParams.from_config(ocp.model, dtype, device)
    tick = batched_tick(ocp.solver, params,
                        discrete_dynamics(blaster_ode, ocp.dt, num_steps=1),
                        make_linearizer(ocp, params),
                        fused_dyn_statics(ocp, 1))
    want = 0 if per_scenario else None

    def step(spec: OCPSpec, states: RTIState, x0s: torch.Tensor):
        bad = [f for f, d in zip(OCPSpec._fields, spec_batch_dims(spec))
               if d != want]
        if bad:
            raise ValueError(
                f"spec fields {bad} "
                + ("lack the per-scenario batch axis" if per_scenario else
                   "carry a batch axis: use "
                   "batched_rti_step_per_scenario_spec"))
        return tick(spec, states, x0s)

    return step


def batched_tick(solver: cfg.SolverConfig, params: BlasterParams, F, lin,
                 dyn_statics):
    """step(spec, states, x0s) -> (u0s, states, diags): the RTI tick over a
    batch on `solver.qp_backend`, with the controller model `F` (its
    `linearizer` `lin`, None for jacfwd) on the host backends and the
    kernel prologue `dyn_statics` on "pallas_fused" ("riccati" and
    "condensed" solve the whole batch eagerly). Spec fields with a leading
    batch axis are per problem, the others shared."""
    _check_backend(solver)
    if solver.qp_backend == "pallas_fused":
        def step(spec: OCPSpec, states: RTIState, x0s: torch.Tensor):
            sol = fused_qp_solve_batched(spec, states, x0s, solver,
                                         dyn_statics)
            return _finish(spec, states, sol)
        return step
    if solver.qp_backend == "pallas":
        def solve(qps):
            return solve_batched_qp(qps, solver)
    else:
        # "riccati" and "condensed" solve the batch on its leading axis
        def solve(qps):
            return solve_qp_backend(qps, solver)

    def step(spec: OCPSpec, states: RTIState, x0s: torch.Tensor):
        qps = vmap(lambda sp, xb, ub, x: build_qp(
            sp, RTIState(xb, ub), x, F, params, linearizer=lin,
            solver=solver), in_dims=(spec_batch_dims(spec), 0, 0, 0))(
                spec, states.xbar, states.ubar, x0s)
        return _finish(spec, states, solve(qps))

    return step


def _finish(spec, states, sol):
    new_states = RTIState(xbar=states.xbar + sol.dx,
                          ubar=states.ubar + sol.du)
    return new_states.ubar[:, 0], new_states, _batched_diag(spec, sol,
                                                            new_states)


def _batched_rti_step_pallas_fused(ocp: cfg.OCPConfig, dtype=torch.float32,
                                   device=None):
    """Batched RTI tick with in-kernel QP assembly and state update: per
    tick the host runs only the batched component-form linearizer, then
    one fuse_cost launch does the rest. The shared spec tensors are
    broadcast over the batch, as the JAX tick does."""
    from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize
    from mpc_blaster_tpu_torch.ops.box_qp_ipm import batched_fused_tick

    params = BlasterParams.from_config(ocp.model, dtype, device)
    solver = ocp.solver

    def step(spec: OCPSpec, states: RTIState, x0s: torch.Tensor):
        B = x0s.shape[0]
        xbar, ubar = states.xbar, states.ubar
        x_pred, A, Bm = fast_linearize(xbar, ubar, spec.stage_params, params,
                                       ocp.dt, 1)
        AB = torch.cat([A, Bm], dim=-1)
        c = x_pred - xbar[:, 1:]
        dtw = spec.dt

        def bc(a):
            return a.expand(B, *a.shape)

        Rg = (dtw * spec.R) if solver.qp_r_floor is not None else None
        new_xbar, new_ubar, dg, _ = batched_fused_tick(
            AB, c, xbar, ubar, x0s,
            bc(dtw * spec.Q), bc(spec.Q_t),
            bc(dtw * qp_hessian_R(spec, solver)),
            bc(spec.yref_x), bc(spec.yref_u), bc(spec.yref_e),
            bc(spec.lbx), bc(spec.ubx), bc(spec.lbu), bc(spec.ubu),
            iters=solver.ipm_iters, mu0=solver.ipm_mu0,
            alpha_frac=solver.ipm_alpha_frac,
            reg=max(solver.ipm_reg, 1e-6),
            R_grad=None if Rg is None else bc(Rg))
        diag = RTIDiagnostics(
            qp_kkt_stat=dg["kkt_stat"], qp_kkt_eq=dg["kkt_eq"],
            qp_mu=dg["mu"], step_norm_x=dg["step_norm_x"],
            step_norm_u=dg["step_norm_u"], bound_viol=dg["bound_viol"])
        return new_ubar[:, 0], RTIState(xbar=new_xbar, ubar=new_ubar), diag

    return step


class Mesh(NamedTuple):
    """A 1-D data-parallel mesh: `devices` (torch.device, one per shard)
    along the axis `axis_names[0]`."""

    devices: tuple
    axis_names: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              device=None) -> Mesh:
    """1-D data-parallel mesh over the first n_devices devices.

    With `device=None` the mesh spans the CUDA cards (all of them, or the
    first n_devices, which raises ValueError if there are fewer); without
    a card it raises, as every entry point of the port does. A `device`
    is repeated n_devices times (default 1): the CPU tests' shards."""
    if device is None:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        if not cards:
            resolve_device()     # raises, naming device="cpu"
        n = len(cards) if n_devices is None else n_devices
        if n > len(cards):
            raise ValueError(f"a mesh of {n} devices asked for; this "
                             f"machine has {len(cards)} CUDA device(s)")
        devs = cards[:n]
    else:
        devs = [torch.device(device)] * (n_devices or 1)
    return Mesh(devices=tuple(devs), axis_names=(axis,))


def _shards(mesh: Mesh, B: int):
    """(device, slice) of each shard of a batch of B."""
    n = mesh.size
    if B % n:
        raise ValueError(f"batch {B} not divisible by the mesh's {n} "
                         "shards")
    k = B // n
    return [(d, slice(i * k, (i + 1) * k))
            for i, d in enumerate(mesh.devices)]


def _spec_to(spec: OCPSpec, device) -> OCPSpec:
    return OCPSpec(*(f.to(device) if isinstance(f, torch.Tensor) else f
                     for f in spec))


def _reduce(shard_vals, op: str, mesh: Mesh) -> torch.Tensor:
    """The mean ("mean") or max ("max") of per-shard scalars over the
    shards, then over the ranks of the process group if one is up (each
    rank holds an equal share of the global batch), on the mesh's first
    device."""
    out_dev = mesh.devices[0]
    v = torch.stack([t.to(out_dev) for t in shard_vals])
    v = v.mean() if op == "mean" else v.amax()
    if dist.is_available() and dist.is_initialized():
        # NCCL reduces on the card, gloo on the host
        on = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
        w = v.to(on).clone()
        dist.all_reduce(w, op=dist.ReduceOp.SUM if op == "mean"
                        else dist.ReduceOp.MAX)
        if op == "mean":
            w = w / dist.get_world_size()
        v = w.to(out_dev)
    return v


def _shard_ticks(ocp: cfg.OCPConfig, mesh: Mesh, dtype):
    """`batched_rti_step`'s tick (shared spec) for each distinct device of
    the mesh."""
    return {d: _batched_tick(ocp, dtype, d, per_scenario=False)
            for d in dict.fromkeys(mesh.devices)}


def sharded_rti_step(ocp: cfg.OCPConfig, mesh: Mesh, dtype=torch.float32,
                     axis: str = "dp"):
    """The batched tick sharded over the mesh's data axis.

    Returns step(spec, states, x0s) -> (u0s, states, mean_step,
    worst_kkt): the batch axis of (states, x0s) is split over the mesh's
    shards (B divisible by the mesh size), the OCPSpec is replicated; each
    shard runs the OCP solver's batched tick on its device; mean_step is
    the pmean of each shard's mean step_norm_u and worst_kkt the pmax of
    its largest qp_kkt_stat, over the shards and the process group's
    ranks. u0s and states come back on the mesh's first device."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} not in the mesh's {mesh.axis_names}")
    ticks = _shard_ticks(ocp, mesh, dtype)
    out_dev = mesh.devices[0]

    def step(spec: OCPSpec, states: RTIState, x0s: torch.Tensor):
        u0s, xbars, ubars, steps, kkts = [], [], [], [], []
        for d, sl in _shards(mesh, x0s.shape[0]):
            u0, st, diag = ticks[d](_spec_to(spec, d),
                                RTIState(states.xbar[sl].to(d),
                                         states.ubar[sl].to(d)),
                                x0s[sl].to(d))
            u0s.append(u0.to(out_dev))
            xbars.append(st.xbar.to(out_dev))
            ubars.append(st.ubar.to(out_dev))
            steps.append(diag.step_norm_u.mean())
            kkts.append(diag.qp_kkt_stat.amax())
        return (torch.cat(u0s), RTIState(torch.cat(xbars), torch.cat(ubars)),
                _reduce(steps, "mean", mesh), _reduce(kkts, "max", mesh))

    return step


def sharded_sweep(ocp: cfg.OCPConfig, mesh: Mesh, n_steps: int,
                  dtype=torch.float32, axis: str = "dp"):
    """Closed-loop scenario sweep sharded over the mesh.

    Returns run(spec, x0s) -> (final states (B, nx), first-tick controls
    (B, nu), mean final position error, worst kkt_eq). Each shard runs its
    scenarios' closed loops together (`sim/scenarios.py::batched_loop`:
    the OCP solver's batched tick for `n_steps` ticks, each followed by
    the plant of `sim/closedloop.py::closed_loop`); the JAX package vmaps
    `closed_loop` instead. Only the two scalars are reduced over the
    shards and ranks."""
    from mpc_blaster_tpu_torch.sim.scenarios import batched_loop

    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} not in the mesh's {mesh.axis_names}")
    ticks = _shard_ticks(ocp, mesh, dtype)
    out_dev = mesh.devices[0]

    def run(spec: OCPSpec, x0s: torch.Tensor):
        finals, first_us, errs, kkts = [], [], [], []
        for d, sl in _shards(mesh, x0s.shape[0]):
            sp = _spec_to(spec, d)
            x, u_first, eq = batched_loop(
                ticks[d], sp, ocp, torch.as_tensor(x0s[sl], dtype=dtype).to(d),
                n_steps, BlasterParams.from_config(ocp.model, dtype, d))
            err = torch.linalg.norm(x[:, 0:3] - sp.yref_x[-1, 0:3], dim=-1)
            finals.append(x.to(out_dev))
            first_us.append(u_first.to(out_dev))
            errs.append(err.mean())
            kkts.append(eq.amax())
        return (torch.cat(finals), torch.cat(first_us),
                _reduce(errs, "mean", mesh), _reduce(kkts, "max", mesh))

    return run
