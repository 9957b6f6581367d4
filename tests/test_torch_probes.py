"""The hardware probes P1 and P2 (`ops/probes.py`) on the CPU: their plain
twins, the chain layouts, and the wrappers' dispatch and refusals. The
kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 18).

P2's twin is held against the Pallas probe it counterparts
(`scripts/probe_r5_sublane.py::make_chain` / `make_sep`, in interpret
mode, loaded from the script with importlib), rows 6 and 24, 1 and 4
chains, within 1e-5 relative: the recurrence contracts (x < 1), so
rounding does not grow with the steps, and where a compiler fuses the
multiply-add the results differ in the last bits only. The contraction
also forgets y and the step count: after ~40 steps every element is
x / (1 - x) to float32 rounding. So the short step counts 1, 3 and 17,
where the result still depends on both, are held beside the script's 200.
"""
import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu_torch.ops import probes as P

REPO = Path(__file__).resolve().parents[1]
STEPS = (1, 3, 17, 200)   # 200: the script's own count in interpret mode
# the settings the script's import changes (a compilation cache in the
# home directory), restored right after it
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_entry_size_bytes",
               "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def sublane():
    """scripts/probe_r5_sublane.py as a module, with JAX's cache settings
    as they were before its import."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    spec = importlib.util.spec_from_file_location(
        "probe_r5_sublane", REPO / "scripts" / "probe_r5_sublane.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _draw(rng, shape):
    return rng.uniform(0.4, 0.6, shape).astype(np.float32)


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("rows", [6, 24])
@pytest.mark.parametrize("nchains", [1, 4])
def test_fma_chain_plain_matches_pallas_probe(sublane, rows, nchains, steps):
    rng = np.random.default_rng(rows * 10 + nchains)
    if rows % nchains == 0:   # row groups of one tile (_chain_kernel)
        x, y = _draw(rng, (rows, P.LANES)), _draw(rng, (rows, P.LANES))
        want = np.asarray(sublane.make_chain(rows, steps, nchains,
                                             interpret=True)(
            jnp.asarray(x), jnp.asarray(y)))
        got = P.fma_chain_plain(P.chain_tiles(torch.as_tensor(x), nchains),
                                P.chain_tiles(torch.as_tensor(y), nchains),
                                steps).reshape(rows, P.LANES)
    else:                     # separate tiles (_sep_ref_kernel)
        xs = [_draw(rng, (rows, P.LANES)) for _ in range(nchains)]
        ys = [_draw(rng, (rows, P.LANES)) for _ in range(nchains)]
        outs = sublane.make_sep(rows, steps, nchains, interpret=True)(
            [jnp.asarray(a) for a in xs], [jnp.asarray(a) for a in ys])
        want = np.stack([np.asarray(o) for o in outs])
        got = P.fma_chain_plain(
            P.sep_tiles([torch.as_tensor(a) for a in xs]),
            P.sep_tiles([torch.as_tensor(a) for a in ys]),
            steps).reshape(nchains, rows, P.LANES)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


def test_fma_chain_layouts_and_dispatch():
    """The chain layouts keep every element where `_chain_kernel` puts it;
    on CPU tensors the wrapper is the twin and launches nothing; shapes
    the kernel does not take are refused on every device."""
    tile = torch.arange(8 * P.LANES, dtype=torch.float32).reshape(8, -1)
    c = P.chain_tiles(tile, 4)
    assert c.shape == (4, 2 * P.LANES)
    assert torch.equal(c[1], tile[2:4].reshape(-1))
    with pytest.raises(ValueError, match="do not split"):
        P.chain_tiles(torch.zeros(6, P.LANES), 4)
    s = P.sep_tiles([tile[:4], tile[4:]])
    assert s.shape == (2, 4 * P.LANES) and torch.equal(s.reshape(8, -1),
                                                       tile)
    x = torch.full((4, 16), 0.5)
    y = torch.zeros(4, 16)
    n0 = P.fma_chain.launches
    out = P.fma_chain(x, y, 3)
    assert P.fma_chain.launches == n0
    # 0 -> 0.5 -> 0.75 -> 0.875
    assert torch.equal(out, torch.full((4, 16), 0.875))
    assert torch.equal(P.fma_chain(x, y, 0), y)
    for bad in (torch.zeros(3, 16), torch.zeros(16)):
        with pytest.raises(ValueError, match="nchains"):
            P.fma_chain(bad, bad, 1)
    with pytest.raises(ValueError, match="float32"):
        P.fma_chain(x.double(), y.double(), 1)
    with pytest.raises(ValueError, match="steps"):
        P.fma_chain(x, y, -1)


def test_smem_capacity_plain_and_refusals():
    """P1's twin writes x and 2x at both ends of `nbytes` and reads back
    3x; on a CPU tensor the wrapper is the twin (no launch); a size that
    is no whole number of words, or a non-(1,) input, is refused; the
    card's ceiling is read from a CUDA device only."""
    x = torch.tensor([1.25])
    for nb in (8, 16 * 1024, 227 * 1024):
        assert P.smem_capacity_plain(x, nb).item() == 3.75
    n0 = P.smem_capacity.launches
    assert P.smem_capacity(x, 48 * 1024).item() == 3.75
    assert P.smem_capacity.launches == n0
    for nb in (4, 1022):
        with pytest.raises(ValueError, match="multiple of 4"):
            P.smem_capacity(x, nb)
    with pytest.raises(ValueError, match=r"\(1,\) float32"):
        P.smem_capacity(torch.tensor([1.0, 2.0]), 1024)
    with pytest.raises(ValueError, match="CUDA device"):
        P.smem_optin_max("cpu")
