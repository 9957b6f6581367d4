"""Port parity of the one-launch tick over a batch against the JAX
package: `parallel/mesh.py::batched_rti_step(backend="xla")` over a
deployed ("pallas_fused") solver, i.e. one launch of the fuse_lin twin for
the whole batch on the CPU, against `jax.vmap` of the JAX tick with its
Pallas kernel in interpret mode.

Tolerances and why: `deployed_solver("safe")`, B=2, N=8, float32. One IPM
iteration pointwise (u0 atol 2e-3, the new iterate atol 5e-3, diagnostics
rtol 1e-3: every phase of the solve has run once); six iterations on the
QP objective of the step (1e-2 relative), kkt_eq (< 1e-2) and feasibility
(the box violation of the new iterate within 1e-3),
tests/test_torch_fused.py's B=1 rules, since past a few iterations f32
rounding moves the weakly determined rotor split (measured here: u0 1.2 N
apart after six iterations on this climb from z=1). Each iteration count
is its own interpret-mode program (nothing to share between the cases).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams as JBP
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu.parallel import mesh as JM
from mpc_blaster_tpu.qp.data import qp_objective
from mpc_blaster_tpu.sqp import rti as jrti
from mpc_blaster_tpu_torch.parallel import mesh as TM
from mpc_blaster_tpu_torch.sqp import rti as trti
from test_torch_batched import DEV, _ocps, _tspec
from torch_threads import one_intraop_thread  # noqa: F401


@pytest.mark.parametrize("iters", [1, 6])
def test_batched_xla_fused_matches_jax(iters):
    """`batched_rti_step(backend="xla")` over the deployed one-launch tick:
    one fuse_lin launch for the batch (its twin on the CPU) against JAX's
    vmapped tick with Pallas in interpret mode, B=2, N=8."""
    jo, to = _ocps(8, lambda pkg: dataclasses.replace(
        pkg.deployed_solver("safe"), ipm_iters=iters))
    js = jbuild_spec(jo, yref=np.asarray(jcfg.simulation_preset().loop.yref),
                     dtype=jnp.float32)
    ts = _tspec(js, torch.float32)
    rng = np.random.default_rng(7)
    x0s = np.zeros((2, jcfg.NX), np.float32)
    x0s[:, 0:3] = rng.uniform(-0.3, 0.3, (2, 3))
    x0s[:, 2] += 1.0
    jx = jnp.asarray(x0s)
    jst = jax.vmap(lambda x: jrti.init_rti_state(jo, x))(jx)
    ju, jnew, jdg = JM.batched_rti_step(jo, backend="xla")(js, jst, jx)
    tx = torch.as_tensor(x0s)
    tu, tnew, tdg = TM.batched_rti_step(to, device=DEV)(
        ts, trti.init_rti_state(to, tx), tx)
    assert torch.isfinite(tu).all()
    if iters == 1:
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                                   atol=2e-3)
        for a, b in ((tnew.xbar, jnew.xbar), (tnew.ubar, jnew.ubar)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=5e-3)
        for f in tdg._fields:
            np.testing.assert_allclose(getattr(tdg, f).numpy(),
                                       np.asarray(getattr(jdg, f)),
                                       rtol=1e-3, atol=1e-6, err_msg=f)
        return
    P = JBP.from_config(jo.model, jnp.float32)
    lin = jrti.make_linearizer(jo, P)
    qps = jax.vmap(lambda st, x: jrti.build_qp(js, st, x, None, P,
                                               linearizer=lin))(jst, jx)

    def obj(new):
        return np.asarray(jax.vmap(qp_objective)(
            qps, jnp.asarray(np.asarray(new.xbar)) - jst.xbar,
            jnp.asarray(np.asarray(new.ubar)) - jst.ubar))
    oj, ot = obj(jnew), obj(tnew)
    assert (np.abs(ot - oj) <= 1e-2 * np.maximum(np.abs(oj), 1.0)).all(), \
        (ot, oj)
    assert (tdg.qp_kkt_eq < 1e-2).all()
    np.testing.assert_allclose(tdg.bound_viol.numpy(),
                               np.asarray(jdg.bound_viol), rtol=0,
                               atol=1e-3)
