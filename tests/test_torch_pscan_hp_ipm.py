"""`box_qp_solve(riccati="pscan", mesh=...)` on a stage-sharded QP: the
horizon-sharded IPM (`mpc_blaster_tpu_torch/qp/ipm.py::_ipm_hp`) against
the unsharded port and JAX's jit of the same solve on a QP whose stage
axis is sharded over the 8-device CPU mesh of tests/conftest.py. The
tolerances and the gaps measured beside them are tests/
test_torch_pscan_hp.py's (its docstring), which holds the scans, the
other modes and `mesh=None`.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mpc_blaster_tpu.qp import ipm as jipm
from mpc_blaster_tpu_torch.qp.data import QPData
from mpc_blaster_tpu_torch.qp.ipm import (IpmWarmStart, box_qp_solve,
                                          warm_start_from)
from test_qp import random_qp
from test_torch_pscan_hp import (_box_qp, _close, _jax_sharded, _mesh,
                                 _objective, _t, _warm)
from torch_threads import one_intraop_thread  # noqa: F401


@functools.lru_cache(maxsize=None)
def _jax_box(dtype_name: str):
    """JAX's jit of the pscan IPM on the sharded box QP, (cold, warm): one
    program per dtype, the cold solve the warm one with valid = 0."""
    jdt, tdt = ((jnp.float64, torch.float64) if dtype_name == "f64"
                else (jnp.float32, torch.float32))
    jd = _jax_sharded(_box_qp(), jdt)
    w = _warm(_t(_box_qp(), tdt))
    jw = jipm.IpmWarmStart(*(jnp.asarray(x.numpy()) for x in w))
    fn = jax.jit(lambda q, w: jipm.box_qp_solve(q, iters=12,
                                                riccati="pscan", warm=w))
    return fn(jd, jw._replace(valid=0 * jw.valid)), fn(jd, jw)


def _hold_f64(sol, ref, d):
    for f in ("dx", "du", "s_lx", "s_ux", "s_lu", "s_uu"):
        _close(getattr(sol, f), getattr(ref, f), 0, 2e-11)
    for f in ("lam_lx", "lam_ux", "lam_lu", "lam_uu"):
        _close(getattr(sol, f), getattr(ref, f), 0, 2e-6)
    for f in ("mu", "kkt_eq"):
        _close(getattr(sol, f), getattr(ref, f), 2e-11, 1e-13)
    _close(sol.kkt_stat, ref.kkt_stat, 0, 1e-9)
    o, o_ref = _objective(d, sol), _objective(d, ref)
    assert abs(o - o_ref) <= 2e-11 * abs(o_ref), (o, o_ref)


def _hold_f32(sol, ref, d):
    o, o_ref = _objective(d, sol), _objective(d, ref)
    assert abs(o - o_ref) <= 1e-3 * abs(o_ref), (o, o_ref)
    eq, eq_ref = float(sol.kkt_eq), float(np.asarray(ref.kkt_eq))
    assert abs(eq - eq_ref) <= 1e-6 + 1e-3 * abs(eq_ref), (eq, eq_ref)


@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("shards", [3, 8])
def test_box_qp_pscan_hp(shards, warm, dtype_name):
    """`box_qp_solve(riccati="pscan")` with bounds active (N=64, 3 shards
    uneven: 22 + 21 + 21 stages), cold and warm, against the port
    unsharded and JAX's jit on the sharded QP; the results come back with
    the whole stage axis in the port's layout."""
    tdt = torch.float64 if dtype_name == "f64" else torch.float32
    d = _t(_box_qp(), tdt)
    w = _warm(d) if warm else None
    sol = box_qp_solve(d, iters=12, riccati="pscan", warm=w,
                       mesh=_mesh(shards))
    ref = box_qp_solve(d, iters=12, riccati="pscan", warm=w)
    for f, a, b in zip(sol._fields, sol, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, f
    assert bool(sol.kkt_eq < 1e-6) or warm
    js = _jax_box(dtype_name)[warm]
    assert js.du.sharding.spec == P("hp")
    hold = _hold_f64 if dtype_name == "f64" else _hold_f32
    hold(sol, ref, d)
    hold(sol, js, d)


def test_box_qp_pscan_hp_batch_axes():
    """A leading batch axis is carried: two QPs solved together on a mesh
    equal each solved alone on it."""
    ds = [_t(random_qp(N=24, nx=4, nu=2, seed=s, bound_scale=0.3))
          for s in (12, 13)]
    both = QPData(*(torch.stack(xs) for xs in zip(*ds)))
    mesh = _mesh(3)
    sol = box_qp_solve(both, iters=10, riccati="pscan", mesh=mesh)
    for i, d in enumerate(ds):
        one = box_qp_solve(d, iters=10, riccati="pscan", mesh=mesh)
        _close(sol.du[i], one.du, 0, 1e-12)
        _close(sol.mu[i], one.mu, 0, 1e-15)


def test_warm_start_layout_round_trip():
    """A sharded solve's slacks and duals come back in the port's layout
    (states 1..N), so its warm start feeds the next sharded solve as the
    unsharded one does."""
    d = _t(_box_qp())
    mesh = _mesh(3)
    sol = box_qp_solve(d, iters=12, riccati="pscan", mesh=mesh)
    w = warm_start_from(sol, shift=True)
    assert isinstance(w, IpmWarmStart) and w.s_lx.shape == (64, 4)
    got = box_qp_solve(d, iters=12, riccati="pscan", warm=w, mesh=mesh)
    ref = box_qp_solve(d, iters=12, riccati="pscan", warm=w)
    _hold_f64(got, ref, d)
