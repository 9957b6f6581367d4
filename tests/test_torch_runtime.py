"""The port's native runtime (`mpc_blaster_tpu_torch/runtime/`): the C++
box-QP IPM against the JAX package's IPM and the port's own
`qp/ipm.py::box_qp_solve`, the rate loop, the ring buffer and the threaded
batch (tests/test_runtime.py's cases on the port's library), and where
the library is built: from the port's copy of the sources into the
git-ignored `mpc_blaster_tpu_torch/build/`, never into the JAX package.
"""
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from mpc_blaster_tpu.qp.data import qp_objective as jqp_objective
from mpc_blaster_tpu.qp.ipm import box_qp_solve as jbox_qp_solve
from mpc_blaster_tpu_torch.convert import qp_from_numpy
from mpc_blaster_tpu_torch.qp.data import qp_objective
from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve
from mpc_blaster_tpu_torch.runtime import bindings
from mpc_blaster_tpu_torch.runtime import (NativeQPSolver, PoseRingBuffer,
                                           RateLoop)
from test_qp import random_qp
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]


def _qps(seed, **kw):
    """The same random QP as the JAX package's QPData and the port's
    (float64, CPU)."""
    jq = random_qp(seed=seed, bound_scale=kw.pop("bound_scale", 2.0), **kw)
    tq = qp_from_numpy({k: np.asarray(v) for k, v in jq._asdict().items()},
                       device=DEV, dtype=torch.float64)
    return jq, tq


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_qp_matches_both_ipms(seed):
    """tests/test_runtime.py:29-44 on the port's library, fed the port's
    QPData: the native solve converges (status 0, kkt_stat < 1e-7,
    kkt_eq < 1e-9) to the optimum both Riccati IPMs reach, du and dx
    within 5e-6 and objectives within 1e-8 relative, of the JAX IPM and
    of the port's."""
    jq, tq = _qps(seed)
    dx, du, stats = NativeQPSolver(iters=15).solve(tq)
    assert stats["status"] == 0
    assert stats["kkt_stat"] < 1e-7, stats
    assert stats["kkt_eq"] < 1e-9, stats
    jsol = jbox_qp_solve(jq, iters=15)
    tsol = box_qp_solve(tq, iters=15)
    obj = float(qp_objective(tq, torch.as_tensor(dx), torch.as_tensor(du)))
    for sdx, sdu, sobj in (
            (np.asarray(jsol.dx), np.asarray(jsol.du),
             float(jqp_objective(jq, jsol.dx, jsol.du))),
            (tsol.dx.numpy(), tsol.du.numpy(),
             float(qp_objective(tq, tsol.dx, tsol.du)))):
        np.testing.assert_allclose(du, sdu, atol=5e-6)
        np.testing.assert_allclose(dx, sdx, atol=5e-6)
        assert obj == pytest.approx(sobj, rel=1e-8, abs=1e-8)
    # the JAX package's array-likes solve the same
    dxj, duj, _ = NativeQPSolver(iters=15).solve(jq)
    np.testing.assert_array_equal(dxj, dx)
    np.testing.assert_array_equal(duj, du)


def test_native_qp_takes_float32_tensors():
    """A float32 QPData (the port's default dtype) is solved in a float64
    copy on the host: the same result as its float64 upcast."""
    jq, tq = _qps(4)
    t32 = type(tq)(*(v.to(torch.float32) for v in tq))
    t64 = type(tq)(*(v.to(torch.float64) for v in t32))
    a = NativeQPSolver(iters=15).solve(t32)
    b = NativeQPSolver(iters=15).solve(t64)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_native_qp_realtime_latency():
    """tests/test_runtime.py:73-89: the CPU path fits the reference's
    33 ms real-time budget, judged on the best of five timed blocks of
    four solves (N=20, 17x6, 10 iterations)."""
    _, tq = _qps(7, N=20, nx=17, nu=6, bound_scale=5.0)
    native = NativeQPSolver(iters=10)
    native.solve(tq)  # warm
    best_ms = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(4):
            native.solve(tq)
        best_ms = min(best_ms, (time.perf_counter() - t0) / 4 * 1e3)
    assert best_ms < 33.3, f"native QP too slow: {best_ms:.1f} ms"


def test_rate_loop_ticks_and_stats():
    rl = RateLoop(200.0)
    t0 = time.perf_counter()
    for _ in range(20):
        rl.sleep()
    elapsed = time.perf_counter() - t0
    assert 0.08 < elapsed < 0.5  # ~20 * 5 ms
    s = rl.stats()
    assert s["ticks"] == 20
    assert s["deadline_misses"] <= 20


def test_pose_ring_latest_and_drain():
    ring = PoseRingBuffer(capacity=8)
    assert ring.latest() is None
    for i in range(12):  # overflow the ring
        ring.push(float(i), [i, 0, 0], [1, 0, 0, 0])
    latest = ring.latest()
    assert latest is not None and latest[0] == 11.0
    drained = ring.drain(max_records=16)
    # capacity 8: the oldest 4 were overwritten
    assert len(drained) == 8
    assert drained[0][0] == 4.0 and drained[-1][0] == 11.0
    np.testing.assert_array_equal(drained[-1][1:8], [11, 0, 0, 1, 0, 0, 0])


def test_native_batch_solve_threads():
    """The threaded batch entry matches per-problem solves (a stacked
    batch of the port's QPData)."""
    datas = [_qps(s)[1] for s in range(6)]
    stacked = type(datas[0])(*(torch.stack(f) for f in zip(*datas)))
    native = NativeQPSolver(iters=15)
    dx_b, du_b, stats = native.solve_batch(stacked, n_threads=3)
    assert stats["status"] == 0
    for i, d in enumerate(datas):
        dx_i, du_i, _ = native.solve(d)
        np.testing.assert_allclose(du_b[i], du_i, atol=1e-12)
        np.testing.assert_allclose(dx_b[i], dx_i, atol=1e-12)
    assert (stats["kkt_stat"] < 1e-6).all()
    # the JAX package's pytree of stacked arrays solves the same
    jstack = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                          *[_qps(s)[0] for s in range(6)])
    np.testing.assert_array_equal(native.solve_batch(jstack, 3)[1], du_b)


def test_library_is_built_in_the_ports_build_dir():
    """The loaded library is the port's: under mpc_blaster_tpu_torch/build/
    with a name that hashes the sources and flags. A build from scratch
    (in a fresh interpreter, into an empty directory) runs one g++ on the
    port's own sources with the JAX package's flags, runs no make, and
    writes nothing into mpc_blaster_tpu/."""
    so = bindings.library_path()
    assert so.parent == REPO / "mpc_blaster_tpu_torch" / "build"
    assert so.name.startswith("libblaster_rt_") and so.exists()
    assert bindings.native_available()
    for name in bindings.SOURCES:
        assert (bindings.NATIVE_DIR / name).exists()
    assert bindings.NATIVE_DIR == (REPO / "mpc_blaster_tpu_torch" / "runtime"
                                   / "native")
    jax_dir = REPO / "mpc_blaster_tpu"
    before = sorted((p, p.stat().st_mtime_ns) for p in jax_dir.rglob("*")
                    if p.is_file() and "__pycache__" not in p.parts)
    code = (
        "import subprocess, sys, tempfile\n"
        "from pathlib import Path\n"
        "from mpc_blaster_tpu_torch.runtime import bindings as b\n"
        "b.BUILD_DIR = Path(tempfile.mkdtemp())\n"
        "calls = []\n"
        "run = subprocess.run\n"
        "def spy(args, **kw):\n"
        "    calls.append((list(args), kw.get('cwd')))\n"
        "    return run(args, **kw)\n"
        "subprocess.run = spy\n"
        "lib = b.load_native()\n"
        "assert lib.rt_rate_create is not None\n"
        "builds = [a for a, _ in calls if '-shared' in a]\n"
        "assert len(builds) == 1, calls\n"
        "a = builds[0]\n"
        "assert a[0] == 'g++' and all(f in a for f in ('-O3', "
        "'-march=native', '-fPIC', '-std=c++17')), a\n"
        "srcs = [x for x in a if x.endswith('.cpp')]\n"
        "assert srcs == [str(b.NATIVE_DIR / n) for n in b.SOURCES], srcs\n"
        "assert not any('make' == c[0][0] or 'mpc_blaster_tpu/' in ' '.join("
        "c[0]) or (c[1] and 'mpc_blaster_tpu/' in str(c[1])) for c in calls),"
        " calls\n"
        "assert list(b.BUILD_DIR.glob('libblaster_rt_*.so'))\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr
    after = sorted((p, p.stat().st_mtime_ns) for p in jax_dir.rglob("*")
                   if p.is_file() and "__pycache__" not in p.parts)
    assert after == before


def test_native_build_goes_through_the_cuda_builder(tmp_path):
    """The native runtime is built by `ops/nvcc_build.py`, as the kernels
    are: its name hashes both sources, the flags and the host target, and
    a compiler that fails raises RuntimeError naming it and the sources,
    leaving no file behind."""
    from mpc_blaster_tpu_torch.ops import nvcc_build
    srcs = tuple(bindings.NATIVE_DIR / n for n in bindings.SOURCES)
    assert bindings.library_path() == nvcc_build.library_path(
        srcs, "libblaster_rt", bindings.CXXFLAGS, bindings._target(),
        bindings.BUILD_DIR)
    other = nvcc_build.library_path(srcs, "libblaster_rt",
                                    bindings.CXXFLAGS, "another target")
    assert other.name != bindings.library_path().name
    assert nvcc_build.library_path(srcs[0], "x") == nvcc_build.library_path(
        (srcs[0],), "x")
    with pytest.raises(RuntimeError, match="false failed on riccati_qp.cpp, "
                                           "executor.cpp"):
        nvcc_build.build(srcs, "libblaster_rt", "false", bindings.CXXFLAGS,
                         "t", tmp_path)
    assert list(tmp_path.iterdir()) == []


def test_failed_build_raises(monkeypatch, tmp_path):
    """A failed native build raises RuntimeError (and keeps raising), as in
    the JAX package; the transport then falls back to its deque."""
    monkeypatch.setattr(bindings, "_lib", None)
    monkeypatch.setattr(bindings, "_build_error", None)
    monkeypatch.setattr(bindings, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(bindings, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="native runtime unavailable"):
        bindings.load_native()
    with pytest.raises(RuntimeError, match="native runtime unavailable"):
        RateLoop(10.0)
    assert not bindings.native_available()
    from mpc_blaster_tpu_torch.io.transport import UdpAttitudeAdapter
    ad = UdpAttitudeAdapter(("127.0.0.1", 9), recv_port=0)
    try:
        assert ad._ring is None and ad.measured_pose() is None
    finally:
        ad.close()
