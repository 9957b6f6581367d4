"""Horizon ("hp") sharding of the port's log-depth scans
(`mpc_blaster_tpu_torch/qp/horizon.py`, the `mesh=` of `qp/pscan.py` and
`qp/ipm.py::box_qp_solve`) against the unsharded port and the JAX package
run on a QP whose stage axis is sharded over the 8-device CPU mesh of
tests/conftest.py (tests/test_pscan.py:107-125). The port's chunks are
CPU shards (`make_mesh(n, axis="hp", device="cpu")`).

Tolerances, each beside the largest gap measured on this file's inputs:
- the sharded scan against `associative_scan`: 1e-12 (f64);
- `lqr_solve_pscan` on 8 shards: tests/test_pscan.py's du rtol 1e-6 /
  atol 1e-7 against JAX's sharded jit and `lqr_solve`; against the port
  unsharded 1e-13 (measured 4.4e-16 on du, 2.5e-16 on dx);
- the factor / solve split sharded against unsharded: 1e-12 (measured
  7.1e-15 on P, 5.6e-16 on K);
- `box_qp_solve(riccati="pscan")` in f64, against the port unsharded and
  JAX's sharded jit: dx, du and the slacks atol 2e-11 (measured 4.2e-12),
  the objective rel 2e-11 (4.8e-12), mu and kkt_eq atol 1e-13 (4.0e-14)
  and rel 2e-11 (a warm solve's kkt_eq of 0.13 parts by 1.3e-13),
  kkt_stat atol 1e-9 (7.8e-11), the duals atol 2e-6 (7.0e-7: the dual of
  a weakly active bound, which twelve iterations leave ill-conditioned;
  the unsharded port against JAX parts as far);
- in f32, past the first iterations two solvers part pointwise (ROADMAP's
  parity notes): the objective rel 1e-3 (measured 4.9e-4) and kkt_eq
  within 1e-6 + 1e-3 |kkt_eq| (measured 3.4e-6 at a kkt_eq of 0.109,
  1.1e-8 at 4.8e-8);
- the "scan", "hybrid" and "sqrt" modes on a mesh against their
  unsharded solves (f64): du and dx atol 5e-8 (measured 5.1e-9,
  "hybrid"), the objective rel 1e-10 (measured 3.2e-12), kkt_eq atol
  1e-13 (7.6e-14);
- `mesh=None`: bit for bit the results of the code before the horizon
  sharding (tests/golden/pscan_hp_mesh_none.npz, `pscan_hp_golden.py`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

import pscan_hp_golden
from mpc_blaster_tpu.qp import pscan as jps
from mpc_blaster_tpu.qp import riccati as jric
from mpc_blaster_tpu_torch.convert import qp_from_numpy
from mpc_blaster_tpu_torch.parallel.mesh import make_mesh
from mpc_blaster_tpu_torch.qp.data import QPData, qp_objective
from mpc_blaster_tpu_torch.qp.horizon import hp_associative_scan
from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve, warm_start_from
from mpc_blaster_tpu_torch.qp.pscan import (associative_scan,
                                            eqp_solve_pscan,
                                            lqr_solve_pscan,
                                            riccati_factorize_pscan,
                                            riccati_solve_rhs_pscan)
from mpc_blaster_tpu_torch.qp.riccati import lqr_solve
from test_qp import random_qp
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")
SHARDED = ("A", "B", "c", "R", "r")    # tests/test_pscan.py's sharded fields


def _mesh(n):
    return make_mesh(n, axis="hp", device="cpu")


def _t(jd, dtype=torch.float64):
    return qp_from_numpy({k: np.asarray(v) for k, v in jd._asdict().items()},
                         dtype=dtype, device=DEV)


def _jax_sharded(jd, dtype=jnp.float64):
    """jd with tests/test_pscan.py:114-121's fields sharded over ("hp",)."""
    mesh = JMesh(np.asarray(jax.devices()[:8]), ("hp",))
    shard = NamedSharding(mesh, P("hp"))
    jd = type(jd)(*(x.astype(dtype) for x in jd))
    return jd._replace(**{f: jax.device_put(getattr(jd, f), shard)
                          for f in SHARDED})


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [8, 9, 64, 65])
@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_hp_scan_matches_associative_scan(shards, n, reverse):
    """The sharded scan of random affine maps (a batch axis in front)
    equals the one-device scan, forward and reversed, at lengths that the
    shard count divides and does not."""
    rng = np.random.default_rng(n + 10 * shards + 100 * reverse)
    F = torch.as_tensor(rng.uniform(-0.6, 0.6, (2, n, 3, 3)))
    g = torch.as_tensor(rng.normal(size=(2, n, 3)))

    def compose(m1, m2):          # m2 after m1
        return m2[0] @ m1[0], (m2[0] @ m1[1][..., None])[..., 0] + m2[1]

    fn = (lambda a, b: compose(b, a)) if reverse else compose
    ref = associative_scan(fn, (F, g), reverse=reverse, dim=1)
    got = hp_associative_scan(fn, (F, g), _mesh(shards), reverse=reverse,
                              dim=1)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


@functools.lru_cache(maxsize=None)
def _jax_lqr():
    jd = random_qp(N=64, nx=4, nu=2, seed=5)
    return jd, jax.jit(jps.lqr_solve_pscan)(_jax_sharded(jd))


@pytest.mark.parametrize("shards", [3, 8])
def test_lqr_pscan_hp_matches_jax_sharded(shards):
    """tests/test_pscan.py:107-125's QP (N=64, nx=4, nu=2, seed 5): the
    port on 8 (and 3) CPU shards against JAX's jit on the 8-device "hp"
    mesh and `lqr_solve`, with that test's tolerances, and against the
    port unsharded."""
    jd, jsol = _jax_lqr()
    assert jsol.du.sharding.spec == P("hp")
    d = _t(jd)
    sol = lqr_solve_pscan(d, mesh=_mesh(shards))
    assert sol.dx.shape == (65, 4) and sol.du.shape == (64, 2)
    _close(sol.du, jsol.du, 1e-6, 1e-7)
    _close(sol.du, jric.lqr_solve(jd).du, 1e-6, 1e-7)
    _close(sol.du, lqr_solve(d).du, 1e-6, 1e-7)
    ref = lqr_solve_pscan(d)
    _close(sol.du, ref.du, 0, 1e-13)
    _close(sol.dx, ref.dx, 0, 1e-13)


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_factor_solve_hp_matches_unsharded(shards):
    """The IPM's factor / solve split and the whole eqp solve, sharded
    against unsharded; the factor's P carries the terminal stage."""
    jd = random_qp(N=64, nx=4, nu=2, seed=7)
    d = _t(jd)
    mesh = _mesh(shards)
    fac = riccati_factorize_pscan(d.A, d.B, d.Q, d.R, 1e-10, mesh=mesh)
    ref = riccati_factorize_pscan(d.A, d.B, d.Q, d.R, 1e-10)
    for a, b in zip(fac, ref):
        assert a.shape == b.shape
        _close(a, b, 0, 1e-12)
    rng = np.random.default_rng(11)
    q2 = torch.as_tensor(rng.normal(size=d.q.shape))
    r2 = torch.as_tensor(rng.normal(size=d.r.shape))
    got = riccati_solve_rhs_pscan(fac, d.A, d.B, d.c, q2, r2, d.dx0,
                                  mesh=mesh)
    want = riccati_solve_rhs_pscan(ref, d.A, d.B, d.c, q2, r2, d.dx0)
    for a, b in zip(got, want):
        _close(a, b, 0, 1e-12)
    got = eqp_solve_pscan(*d[:7], d.dx0, 1e-10, mesh)
    want = eqp_solve_pscan(*d[:7], d.dx0, 1e-10)
    for a, b in zip(got, want):
        _close(a, b, 0, 1e-12)


def _box_qp():
    return random_qp(N=64, nx=4, nu=2, seed=6, bound_scale=0.3)


def _warm(d):
    """A warm start whose shift moves every stage across the chunk
    boundaries: the unsharded cold solve's, shifted one stage."""
    return warm_start_from(box_qp_solve(d, iters=12, riccati="pscan"),
                           shift=True)


def _objective(d, s):
    d64 = QPData(*(x.double() for x in d))
    return float(qp_objective(d64, torch.as_tensor(np.array(s.dx)).double(),
                              torch.as_tensor(np.array(s.du)).double()))


@pytest.mark.parametrize("shards", [3, 8])
@pytest.mark.parametrize("mode", ["scan", "hybrid", "sqrt"])
def test_other_modes_on_mesh(mode, shards):
    """The other Riccati modes on a mesh (their recursions on the whole
    horizon gathered, the per-stage work sharded) equal their unsharded
    solves, cold and warm."""
    d = _t(_box_qp())
    w = _warm(d)
    for warm in (None, w):
        sol = box_qp_solve(d, iters=12, riccati=mode, warm=warm,
                           mesh=_mesh(shards))
        ref = box_qp_solve(d, iters=12, riccati=mode, warm=warm)
        _close(sol.du, ref.du, 0, 5e-8)
        _close(sol.dx, ref.dx, 0, 5e-8)
        o, o_ref = _objective(d, sol), _objective(d, ref)
        assert abs(o - o_ref) <= 1e-10 * abs(o_ref), (mode, o, o_ref)
        _close(sol.kkt_eq, ref.kkt_eq, 0, 1e-13)


def test_mesh_none_is_the_unsharded_code():
    """`mesh=None` gives, bit for bit, what every pscan solve and every
    IPM mode gave before the horizon sharding (f64 and f32, cold and
    warm)."""
    gold = np.load(f"{pscan_hp_golden.__file__.rsplit('/', 1)[0]}/golden/"
                   f"{pscan_hp_golden.GOLDEN}")
    now = pscan_hp_golden.cases({"mesh": None})
    assert sorted(now) == sorted(gold.files)
    for k, v in now.items():
        np.testing.assert_array_equal(v, gold[k], err_msg=k)


def test_mesh_without_hp_axis_raises():
    """A mesh without the "hp" axis raises, as `sharded_rti_step` does for
    a missing axis; nothing falls back to one device."""
    d = _t(_box_qp())
    dp = make_mesh(2, device="cpu")
    fac = riccati_factorize_pscan(d.A, d.B, d.Q, d.R)
    calls = (lambda: lqr_solve_pscan(d, mesh=dp),
             lambda: eqp_solve_pscan(*d[:7], d.dx0, mesh=dp),
             lambda: riccati_factorize_pscan(d.A, d.B, d.Q, d.R, mesh=dp),
             lambda: riccati_solve_rhs_pscan(fac, d.A, d.B, d.c, d.q, d.r,
                                             d.dx0, mesh=dp),
             lambda: box_qp_solve(d, riccati="pscan", mesh=dp),
             lambda: box_qp_solve(d, riccati="scan", mesh=dp))
    for call in calls:
        with pytest.raises(ValueError, match="'hp'"):
            call()


def test_fewer_stages_than_chunks_raises():
    d = _t(random_qp(N=5, nx=4, nu=2, seed=1, bound_scale=0.3))
    with pytest.raises(ValueError, match="cannot be split"):
        lqr_solve_pscan(d, mesh=_mesh(8))
    with pytest.raises(ValueError, match="cannot be split"):
        box_qp_solve(d, riccati="pscan", mesh=_mesh(6))
    box_qp_solve(d, riccati="pscan", mesh=_mesh(5))   # one stage a chunk
