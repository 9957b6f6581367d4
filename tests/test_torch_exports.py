"""The port's subpackages export what the JAX package's subpackages export:
every name a `mpc_blaster_tpu/<sub>/__init__.py` imports is importable from
`mpc_blaster_tpu_torch.<sub>` and is the port module's own object, or is
listed below as not ported yet, with the ROADMAP queue 1 step that ports
it. The JAX side is read from its source (`ast`), so this file imports
nothing of JAX; each of the port's subpackages is imported in a fresh
interpreter, where it must build nothing, leave CUDA uninitialised and
load nothing of JAX.
"""
import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest
from torch_threads import one_intraop_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "mpc_blaster_tpu"

# Whole subpackages of the JAX package that the port does not have yet.
SUBPACKAGES_NOT_YET: dict = {}
# Single names not ported yet, per subpackage.
NAMES_NOT_YET: dict = {}
# The JAX `ops` exports Pallas entry points; the port's `ops` exports its
# own kernels' wrappers. The counterpart of each Pallas name, or None with
# the reason it has none.
OPS_COUNTERPARTS = {
    "pallas_box_qp_solve": "box_qp_solve",
    # asks whether JAX's default device is a TPU; the port's kernels run
    # for any CUDA tensor and the card is its default device
    # (`device.py::resolve_device`)
    "pallas_available": None,
}


def _subpackages():
    return sorted(p.parent.name for p in JAX_PKG.glob("*/__init__.py"))


def _jax_exports(sub):
    """(name, defining module) of every name the JAX subpackage's
    `__init__.py` imports."""
    tree = ast.parse((JAX_PKG / sub / "__init__.py").read_text())
    out = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                out.append((a.asname or a.name, node.module))
    return out


def _cases():
    return [(sub, name, mod) for sub in _subpackages()
            if sub not in SUBPACKAGES_NOT_YET
            for name, mod in _jax_exports(sub)]


def test_every_subpackage_is_covered():
    """Each JAX subpackage is ported (a package of the same name in the
    port) or listed as not yet, and each listed name is one the JAX
    package exports."""
    subs = _subpackages()
    assert set(SUBPACKAGES_NOT_YET) <= set(subs)
    for sub in subs:
        ported = (REPO / "mpc_blaster_tpu_torch" / sub /
                  "__init__.py").exists()
        assert ported != (sub in SUBPACKAGES_NOT_YET), sub
    for sub, names in NAMES_NOT_YET.items():
        assert set(names) <= {n for n, _ in _jax_exports(sub)}, sub
    assert set(OPS_COUNTERPARTS) == {n for n, _ in _jax_exports("ops")}


@pytest.mark.parametrize("sub,name,jax_module", _cases(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_subpackage_exports_follow_jax(sub, name, jax_module):
    """`from mpc_blaster_tpu_torch.<sub> import <name>` works and gives the
    port module's object, the counterpart of the JAX one."""
    pkg = importlib.import_module(f"mpc_blaster_tpu_torch.{sub}")
    if name in NAMES_NOT_YET.get(sub, {}):
        assert not hasattr(pkg, name), \
            f"{sub}.{name} is ported: drop it from NAMES_NOT_YET"
        return
    if sub == "ops":
        name = OPS_COUNTERPARTS[name]
        if name is None:
            return
        jax_module = "mpc_blaster_tpu.ops.box_qp_ipm"
    assert hasattr(pkg, name), f"mpc_blaster_tpu_torch.{sub} lacks {name}"
    # the defining module's counterpart in the port holds the same object
    port_module = importlib.import_module(
        jax_module.replace("mpc_blaster_tpu", "mpc_blaster_tpu_torch", 1))
    assert getattr(pkg, name) is getattr(port_module, name)


def test_subpackage_imports_build_nothing():
    """Importing every subpackage of the port, in a fresh interpreter,
    compiles no kernel, leaves CUDA uninitialised and loads nothing of
    JAX or of the JAX package."""
    subs = [s for s in _subpackages() if s not in SUBPACKAGES_NOT_YET]
    code = ("import importlib, sys\n"
            "import mpc_blaster_tpu_torch.ops.nvcc_build as nb\n"
            "calls = []\n"
            "nb.build = lambda *a, **k: calls.append(a)\n"
            f"for s in {subs!r}:\n"
            "    importlib.import_module('mpc_blaster_tpu_torch.' + s)\n"
            "import torch\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert not calls, calls\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'mpc_blaster_tpu') or m.startswith(('jax.', 'jaxlib.', "
            "'mpc_blaster_tpu.')))\n"
            "assert not bad, bad\n"
            "from mpc_blaster_tpu_torch.sim import run_preset\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr
