"""Port parity of the batched tick over per-problem specs against the JAX
package: `parallel/mesh.py::batched_rti_step_per_scenario_spec` on its
three backends, and the spec forms each batched entry point takes. The
one-launch tick over a batch (`batched_rti_step(backend="xla")` over a
deployed solver) is in tests/test_torch_batched_xla.py, the sweeps'
"pallas" tick in tests/test_torch_sweeps_f32.py.

Tolerances and why:
  - the per-scenario-spec tick on "riccati" in float64
    (tests/test_parallel.py::test_batched_step_per_scenario_spec's case,
    N=24, B=4): u0 and the new iterate within 1e-6, kkt_eq within 1e-3
    relative (the same Riccati IPM in both packages; measured 4e-9);
  - on "pallas" and "pallas_fused" (the twins) each scenario's tick equals
    the port's own B=1 tick with that scenario's spec within 1e-5 (the
    batched and the single twin order some products differently); the
    B=1 ticks are held against the JAX package in
    tests/test_torch_rti.py and tests/test_torch_fused.py.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu.parallel import mesh as JM
from mpc_blaster_tpu.sqp import rti as jrti
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.convert import spec_from_numpy
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec
from mpc_blaster_tpu_torch.parallel import mesh as TM
from mpc_blaster_tpu_torch.sqp import rti as trti
from torch_threads import one_intraop_thread  # noqa: F401


# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")


def _ocps(N, solver=None):
    """(JAX, port) configs: the simulation preset at horizon N, same dt,
    with `solver(package)` as its solver (default: the preset's)."""
    out = []
    for pkg in (jcfg, cfg):
        base = pkg.simulation_preset().ocp
        out.append(dataclasses.replace(
            base, N=N, Tf=N / 30.0,
            solver=base.solver if solver is None else solver(pkg)))
    return out


def _tspec(js, dtype):
    return spec_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                           dtype=dtype, device=DEV)


def _per_scenario(jo, jdt, tdt, Bs=4):
    """tests/test_parallel.py's case: N=24 x0 draws around z=2 and one
    spec per scenario with altitude targets 2.0 + 0.3 i; (JAX stacked
    spec, port stacked spec, x0s)."""
    rng = np.random.default_rng(3)
    x0s = np.zeros((16, jcfg.NX))
    x0s[:, 0:3] = rng.uniform(-0.5, 0.5, (16, 3))
    x0s[:, 2] += 2.0
    specs = []
    for i in range(Bs):
        yref = np.zeros(jcfg.NY)
        yref[2] = 2.0 + 0.3 * i
        specs.append(jbuild_spec(jo, yref=yref, dtype=jdt))
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *specs)
    tstack = OCPSpec(*(torch.stack(f) for f in zip(
        *(_tspec(s, tdt) for s in specs))))
    return jstack, tstack, x0s[:Bs]


def test_per_scenario_spec_matches_jax_riccati():
    jo, to = _ocps(24)
    js, ts, x0s = _per_scenario(jo, jnp.float64, torch.float64)
    jx = jnp.asarray(x0s)
    jst = jax.vmap(lambda x: jrti.init_rti_state(jo, x, jnp.float64))(jx)
    ju, jnew, jdg = JM.batched_rti_step_per_scenario_spec(
        jo, dtype=jnp.float64)(js, jst, jx)
    tx = torch.as_tensor(x0s)
    tst = trti.init_rti_state(to, tx, torch.float64)
    tu, tnew, tdg = TM.batched_rti_step_per_scenario_spec(
        to, dtype=torch.float64, device=DEV)(ts, tst, tx)
    assert tu.shape == (4, jcfg.NU) and torch.isfinite(tu).all()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tnew.xbar.numpy(), np.asarray(jnew.xbar),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tdg.qp_kkt_eq.numpy(),
                               np.asarray(jdg.qp_kkt_eq), rtol=1e-3,
                               atol=1e-12)
    # higher targets demand more climb: the velocity plans differ
    assert tnew.xbar[:, 10, 8].std() > 1e-3


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_per_scenario_spec_kernel_backends(backend):
    """One launch for the batch, each problem its own spec: every scenario
    equals the port's B=1 tick with its spec."""
    jo, to = _ocps(8, lambda pkg: dataclasses.replace(
        pkg.deployed_solver("safe"), qp_backend=backend))
    _, ts, x0s = _per_scenario(jo, jnp.float32, torch.float32)
    tx = torch.as_tensor(x0s, dtype=torch.float32)
    st = trti.init_rti_state(to, tx)
    u, new, dg = TM.batched_rti_step_per_scenario_spec(to, device=DEV)(
        ts, st, tx)
    one = trti.make_rti_step(to, device=DEV)
    for i in range(4):
        si = OCPSpec(*(f[i] for f in ts))
        ui, sti, dgi = one(si, trti.RTIState(st.xbar[i], st.ubar[i]), tx[i])
        torch.testing.assert_close(u[i], ui, rtol=0, atol=1e-5)
        torch.testing.assert_close(new.xbar[i], sti.xbar, rtol=0, atol=1e-5)
        torch.testing.assert_close(dg.bound_viol[i], dgi.bound_viol,
                                   rtol=0, atol=1e-5)


def test_spec_forms_refused():
    """`batched_rti_step` takes a shared spec and
    `batched_rti_step_per_scenario_spec` one spec per scenario; each
    refuses the other form before any solve."""
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    _, to = _ocps(8)
    shared = build_spec(to, device=DEV)
    per = OCPSpec(*(f.expand(2, *f.shape) for f in shared))
    x = torch.zeros(2, cfg.NX)
    st = trti.init_rti_state(to, x)
    with pytest.raises(ValueError, match="per_scenario_spec"):
        TM.batched_rti_step(to, device=DEV)(per, st, x)
    mixed = per._replace(Q=shared.Q)
    with pytest.raises(ValueError, match=r"\['Q'\] lack"):
        TM.batched_rti_step_per_scenario_spec(to, device=DEV)(mixed, st, x)
