"""`python -m mpc_blaster_tpu_torch`, the port's build-sanity CLI, against
`python -m mpc_blaster_tpu`: the smoke preset's first RTI tick prints the
same u0 (tolerance 1e-3 N on 4-decimal prints; measured gap 0 between the
two packages' float32 ticks on the CPU), and chip_smoke.py's phase-23
constant is that JAX tick, recomputed here. Without a card a bare call
exits non-zero and says how to ask for the CPU.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest

import chip_smoke
from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.ocp.spec import build_spec
from mpc_blaster_tpu.sqp.rti import init_rti_state, make_rti_step
from torch_threads import one_intraop_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _jax_main_u0() -> np.ndarray:
    """The tick of `mpc_blaster_tpu/__main__.py:24-29`, in float32 as that
    entry point runs it (the tests' x64 switch must not promote x0)."""
    ocp = cfg.smoke_preset().ocp
    x0 = jnp.zeros(cfg.NX, jnp.float32).at[2].set(1.0)
    u0, _, _ = make_rti_step(ocp)(build_spec(ocp), init_rti_state(ocp, x0),
                                  x0)
    return np.asarray(u0)


def _run(*args, env=None):
    return subprocess.run([sys.executable, "-m", "mpc_blaster_tpu_torch",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=env)


def test_chip_smoke_cli_constant_is_jax_tick():
    """The constant is the JAX tick's u0 as its CLI prints it (4
    decimals)."""
    u0 = _jax_main_u0().astype(np.float64).round(4)
    assert tuple(u0.tolist()) == chip_smoke.CLI_U0_JAX


def test_cli_on_cpu_matches_jax_tick():
    res = _run("--device", "cpu")
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "smoke build: N=30 Tf=1.0 mass=10.0 on cpu" in out
    u0 = chip_smoke.parse_cli_u0(out)
    np.testing.assert_allclose(u0, _jax_main_u0(), rtol=0,
                               atol=chip_smoke.CLI_U0_TOL)
    qp_eq = float(re.search(r"qp_eq = (\S+)", out)[1])
    assert np.isfinite(qp_eq)
    # R(0.1, -0.2, 0.3): the three printed rows are a rotation
    rows = re.findall(r"\[\[?\s*([-\d. ]+)\]", out.split("R(0.1")[1])
    R = np.array([[float(v) for v in r.split()] for r in rows])
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)


def test_bare_cli_without_card_names_the_cpu_switch():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _run(env=env)
    assert res.returncode != 0
    assert 'device="cpu"' in res.stderr, res.stderr
    assert "u0" not in res.stdout


@pytest.mark.parametrize("example", sorted(
    p.name for p in (REPO / "examples").glob("torch_*.py")))
def test_example_without_card_names_the_cpu_switch(example):
    """Each port example runs on the card unless `--device` says
    otherwise; without one it exits non-zero before any work."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, f"examples/{example}"], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode != 0
    assert 'device="cpu"' in res.stderr, res.stderr
