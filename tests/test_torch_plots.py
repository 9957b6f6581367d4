"""The port's plots (`mpc_blaster_tpu_torch/sim/plots.py`, headless Agg):
tests/test_plots.py's three figures drawn from the port's own runs on
the CPU (each written file must exceed 10 kB, the JAX test's bound), and
the jet figure's impact point against the JAX package's closed form on the
same pose (1e-9, float64).
"""
import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.sim.closedloop import run_preset
from mpc_blaster_tpu_torch.sim.plots import (plot_blast_scan,
                                             plot_closed_loop,
                                             plot_jet_trajectory)
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")


def test_closed_loop_plot(tmp_path):
    res = run_preset(cfg.simulation_preset(), n_steps=10,
                     dtype=torch.float64, device=DEV)
    path = plot_closed_loop(res, 1 / 30.0, path=str(tmp_path / "cl.png"))
    assert os.path.getsize(path) > 10_000


def test_jet_plot(tmp_path):
    from mpc_blaster_tpu.poc.jet import jet_init_conditions
    from mpc_blaster_tpu.poc.solver import time_of_impact
    from mpc_blaster_tpu_torch.poc.jet import jet_init_conditions as tinit
    from mpc_blaster_tpu_torch.poc.solver import time_of_impact as ttoi
    pose = ([0.0, -0.05, 0.0], [0.2117, 0.0], [0.6, 0.0, 3.5])
    path = plot_jet_trajectory(*pose, path=str(tmp_path / "jet.png"),
                               device=DEV)
    assert os.path.getsize(path) > 10_000
    init = tinit(*(torch.as_tensor(p, dtype=torch.float64) for p in pose),
                 150.0)
    jinit = jet_init_conditions(*(jnp.asarray(p, jnp.float64) for p in pose),
                                150.0)
    np.testing.assert_allclose(init.numpy(), np.asarray(jinit), atol=1e-9)
    assert abs(float(ttoi(init, 1.0)) - float(time_of_impact(jinit, 1.0))) \
        < 1e-9


def test_blast_scan_plot(tmp_path):
    from mpc_blaster_tpu_torch.sim.tasks import run_blast_scan
    pre = cfg.simulation_preset()
    preset = dataclasses.replace(pre, ocp=dataclasses.replace(
        pre.ocp, N=20, Tf=20 / 30.0))
    res = run_blast_scan(preset=preset, n_steps=12, dtype=torch.float64,
                         device=DEV)
    path = plot_blast_scan({"anchored": res},
                           path=str(tmp_path / "scan.png"), settle=2)
    assert os.path.getsize(path) > 10_000
