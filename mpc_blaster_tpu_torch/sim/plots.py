"""Plotting: the reference's matplotlib figures.

Port of `mpc_blaster_tpu/sim/plots.py`: the closed-loop panels of
`simulation_blaster.py:109-128` (position, POC, Euler, gimbal, plus the
rotor thrusts), the blast scan's true impact pattern and error, and the
3-D jet trajectory of `Jacobian_POC_Solver._simulateBlastPlot`. Tensors
on any device are drawn from their host copies; headless (Agg backend).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from mpc_blaster_tpu_torch.device import resolve_device  # noqa: E402
from mpc_blaster_tpu_torch.poc.jet import (jet_init_conditions,  # noqa: E402
                                           jet_state)
from mpc_blaster_tpu_torch.poc.solver import (time_of_impact,  # noqa: E402
                                              true_poc_traj)
from mpc_blaster_tpu_torch.utils.metrics import _np  # noqa: E402


def plot_closed_loop(result, dt: float, path: Optional[str] = None):
    """4-panel figure: position, POC, Euler, gimbal (reference panels) +
    rotor thrusts."""
    xs = _np(result.xs)
    us = _np(result.us)
    t = np.arange(xs.shape[0]) * dt

    fig, axes = plt.subplots(5, 1, figsize=(9, 14), sharex=True)
    for i, lbl in enumerate("xyz"):
        axes[0].plot(t, xs[:, i], label=lbl)
    axes[0].set_ylabel("position [m]"); axes[0].legend()
    for i, lbl in zip(range(14, 17), ("POC_x", "POC_y", "POC_z")):
        axes[1].plot(t, xs[:, i], label=lbl)
    axes[1].set_ylabel("POC [m]"); axes[1].legend()
    for i, lbl in zip(range(3, 6), ("phi", "theta", "psi")):
        axes[2].plot(t, xs[:, i], label=lbl)
    axes[2].set_ylabel("euler [rad]"); axes[2].legend()
    for i, lbl in zip(range(12, 14), ("alpha1", "alpha2")):
        axes[3].plot(t, xs[:, i], label=lbl)
    axes[3].set_ylabel("gimbal [rad]"); axes[3].legend()
    for i in range(4):
        axes[4].plot(t[:-1], us[:, i], label=f"T{i+1}")
    axes[4].set_ylabel("thrust [N]"); axes[4].set_xlabel("t [s]")
    axes[4].legend()
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path
    return fig


def plot_blast_scan(results: dict, path: Optional[str] = None,
                    settle: int = 60):
    """Blast-scan figure: true-POC washing accuracy per configuration.

    results: {label: TrackingResult} from `sim.tasks.run_blast_scan` (the
    plant's truth is re-evaluated here by `poc.solver.true_poc_traj`, on
    the device of each result, so linear-belief runs are judged against
    physics, not their own belief). Left: the commanded ground pattern
    against the true jet impact traces. Right: the true error over time
    and the altitude ramp that makes frozen linearizations stale.
    """
    fig, (axg, axt) = plt.subplots(1, 2, figsize=(13, 5.5))
    first = next(iter(results.values()))
    refs = _np(first.refs)
    dt_guess = 1 / 30.0
    t = (np.arange(refs.shape[0]) + 1) * dt_guess
    axg.plot(refs[:, 14], refs[:, 15], "k--", lw=1.2,
             label="commanded pattern")
    for label, res in results.items():
        tp = _np(true_poc_traj(res.xs))
        err = np.linalg.norm(tp[1:, 0:2] - _np(res.refs)[:, 14:16], axis=1)
        axg.plot(tp[settle:, 0], tp[settle:, 1], lw=1.0,
                 label=f"{label} (true impact)")
        axt.plot(t, err, lw=1.0,
                 label=f"{label}: mean {err[settle:].mean()*1e3:.1f} mm")
    axg.set_xlabel("ground x [m]"); axg.set_ylabel("ground y [m]")
    axg.set_title("water-jet impact pattern"); axg.legend(); axg.axis("equal")
    axz = axt.twinx()
    axz.plot(t, refs[:, 2], color="0.7", lw=0.8)
    axz.set_ylabel("altitude ref [m]", color="0.5")
    axt.set_xlabel("t [s]"); axt.set_ylabel("TRUE |POC err| [m]")
    axt.set_title("physical washing error"); axt.legend()
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path
    return fig


def plot_jet_trajectory(euler, alpha, position, stream_velocity=150.0,
                        drag=1.0, n_points: int = 120,
                        path: Optional[str] = None, device=None):
    """3-D jet trajectory from nozzle to ground (the reference's
    `_simulateBlastPlot`), from the closed-form solution, computed in
    float64 on `device` (default: a tensor argument's, else the card)."""
    dev = resolve_device(device, euler, alpha, position)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)
    init = jet_init_conditions(t(euler), t(alpha), t(position),
                               stream_velocity)
    T = float(time_of_impact(init, drag))
    ts = np.linspace(0.0, T, n_points)
    pts = np.stack([_np(jet_state(t(tk), init, drag)[0:3]) for tk in ts])

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ax.plot3D(pts[:, 0], pts[:, 1], pts[:, 2])
    ax.scatter(*pts[-1], color="r", label="POC")
    ax.set_xlabel("X"); ax.set_ylabel("Y"); ax.set_zlabel("Z")
    ax.legend()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path
    return fig
