"""The PyTorch port imports no JAX: every slice module is imported in a
fresh interpreter, which must then hold no ``jax`` module and no module of
the JAX package ``sp_coupler_tpu``."""

import os
import subprocess
import sys

MODULES = (
    "sp_coupler_tpu_torch",
    "sp_coupler_tpu_torch.interop",
    "sp_coupler_tpu_torch.constants",
    "sp_coupler_tpu_torch.utils.thermo",
    "sp_coupler_tpu_torch.utils.interp",
    "sp_coupler_tpu_torch.models.les.grid",
    "sp_coupler_tpu_torch.models.les.state",
    "sp_coupler_tpu_torch.models.les.advect",
    "sp_coupler_tpu_torch.models.les.subgrid",
    "sp_coupler_tpu_torch.models.les.micro",
    "sp_coupler_tpu_torch.models.les.poisson",
    "sp_coupler_tpu_torch.models.les.step",
    "sp_coupler_tpu_torch.models.les.diag",
    "sp_coupler_tpu_torch.ops.lesstage",
    "sp_coupler_tpu_torch.ops.lesflat",
    "sp_coupler_tpu_torch.ops.lesmom",
    "sp_coupler_tpu_torch.ops.advect",
    "sp_coupler_tpu_torch.ops._build",
    "sp_coupler_tpu_torch.ops.tiling",
    "sp_coupler_tpu_torch.coupling.convert",
    "sp_coupler_tpu_torch.coupling.coupler",
    "sp_coupler_tpu_torch.models.gcm.spharm",
    "sp_coupler_tpu_torch.models.gcm.vertical",
    "sp_coupler_tpu_torch.models.gcm.dycore",
    "sp_coupler_tpu_torch.models.gcm.physics",
    "sp_coupler_tpu_torch.models.gcm.model",
    "sp_coupler_tpu_torch.models.gcm.semilag",
    "sp_coupler_tpu_torch.config",
    "sp_coupler_tpu_torch.utils.geometry",
    "sp_coupler_tpu_torch.utils.decks",
    "sp_coupler_tpu_torch.utils.tree",
    "sp_coupler_tpu_torch.io.h5lite",
    "sp_coupler_tpu_torch.io.h5nc",
    "sp_coupler_tpu_torch.io.spifs",
    "sp_coupler_tpu_torch.io.restart",
    "sp_coupler_tpu_torch.coupling.nudge",
    "sp_coupler_tpu_torch.models.les.model",
    "sp_coupler_tpu_torch.models.dummy",
    "sp_coupler_tpu_torch.runtime.driver",
    "sp_coupler_tpu_torch.spmaster",
    "sp_coupler_tpu_torch.verify.golden",
    "sp_coupler_tpu_torch.verify.late_state",
    "sp_coupler_tpu_torch.verify.parity",
    "sp_coupler_tpu_torch.models.ncreplay",
    "sp_coupler_tpu_torch.io.spnc",
    "sp_coupler_tpu_torch.io.crossio",
    "sp_coupler_tpu_torch.parallel.bands",
    "sp_coupler_tpu_torch.parallel.mesh",
    "sp_coupler_tpu_torch.parallel.plane",
    "sp_coupler_tpu_torch.parallel.sharding",
    "sp_coupler_tpu_torch.runtime.scalebench",
    "sp_coupler_tpu_torch.runtime.columnbench",
    "sp_coupler_tpu_torch.runtime.gcmscale",
    "sp_coupler_tpu_torch.runtime.tl639",
    "sp_coupler_tpu_torch.runtime.t255bench",
    "sp_coupler_tpu_torch.verify.held_suarez",
    "sp_coupler_tpu_torch.verify.hs_bisect",
    "sp_coupler_tpu_torch.verify.moist_endurance",
    "sp_coupler_tpu_torch.verify.parity_report",
    "sp_coupler_tpu_torch.ops.bounds",
    "sp_coupler_tpu_torch.bench",
    "sp_coupler_tpu_torch.runtime.t159bench",
    "sp_coupler_tpu_torch.runtime.schedulebench",
    "sp_coupler_tpu_torch.runtime.batchbench",
    "sp_coupler_tpu_torch.verify.tl639_rows",
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            "for m in %r:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m in ('jax', 'sp_coupler_tpu')\n"
            "             or m.startswith(('jax.', 'jaxlib',\n"
            "                              'sp_coupler_tpu.')))\n"
            "assert not bad, bad\n"
            "print('ok', len(%r))\n" % (MODULES, MODULES))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "ok %d" % len(MODULES)


def test_every_port_module_is_listed():
    """A new module of the port joins the import check above."""
    pkg = os.path.join(ROOT, "sp_coupler_tpu_torch")
    found = set()
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                found.add(mod[:-len(".__init__")] if mod.endswith(
                    ".__init__") else mod)
    packages = {m for m in found if os.path.isdir(
        os.path.join(ROOT, m.replace(".", os.sep)))}
    assert found - packages == set(MODULES) - {"sp_coupler_tpu_torch"}


def test_constants_match_the_jax_package():
    from sp_coupler_tpu import constants as ref
    from sp_coupler_tpu_torch import constants as port
    names = {k for k in vars(ref) if not k.startswith("_")}
    assert names == {k for k in vars(port) if not k.startswith("_")}
    for k in sorted(names):
        assert getattr(port, k) == getattr(ref, k), k
