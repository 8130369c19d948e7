"""The port's scalar and momentum kernel modules (sp_coupler_tpu_torch/ops/
lesflat.py, lesmom.py, advect.py) vs the JAX package's Pallas kernels, and
the on-card check of chip_smoke.py against plain versions with a term
removed.

The plain PyTorch versions (what the wrappers run on CPU tensors) are held
against the Pallas kernels in interpret mode at the setup and tolerances
of tests/test_ops.py; the CUDA kernels themselves run only on a card,
against these plain versions: tests/test_torch_cuda.py and chip_smoke.py.
"""

import re
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke as cs
from sp_coupler_tpu.models.les import grid as jgrid
from sp_coupler_tpu.ops import (lesflat_pallas as jflat, lesmom_pallas as jmom,
                                advect_pallas as jadv)
from sp_coupler_tpu_torch.models.les import grid as tgrid, advect, subgrid
from sp_coupler_tpu_torch.ops import lesflat, lesmom, _build
from sp_coupler_tpu_torch.ops import advect as tadv

torch.set_num_threads(1)

NZ, NY, NX, S = 32, 16, 16, 4
JG = jgrid.LESGrid(nx=NX, ny=NY, nz=NZ, dz=25.0)
SCALAR_TOL = dict(atol=2e-4, rtol=1e-4)     # tests/test_ops.py:42
MOM_TOL = dict(atol=5e-5, rtol=1e-4)        # tests/test_ops.py:125


@pytest.fixture(scope="module")
def case():
    """tests/test_ops.py's inputs (w zero on the outer faces), as numpy,
    for a fleet of 3: instance i has u + 0.1 i and scalars + 0.01 i."""
    rng = np.random.default_rng(0)
    f32 = lambda a: np.asarray(a, np.float32)
    u = f32(rng.normal(0, 3, (NZ, NY, NX)))
    v = f32(rng.normal(0, 3, (NZ, NY, NX)))
    w = f32(rng.normal(0, 1, (NZ + 1, NY, NX)))
    w[0] = w[-1] = 0.0
    scal = f32(rng.normal(300, 5, (S, NZ, NY, NX)))
    Ks = f32(rng.uniform(0.1, 20.0, (S, NZ, NY, NX)))
    n = 3
    fleet = lambda a, step: f32([a + step * i for i in range(n)])
    rep = lambda a: f32(np.tile(a, (n,) + (1,) * a.ndim))
    return dict(u=fleet(u, 0.1), v=rep(v), w=rep(w), Ks=rep(Ks),
                scalars=fleet(scal, 0.01),
                rhobf=rep(f32(np.linspace(1.2, 0.7, NZ))),
                rhobh=rep(f32(np.linspace(1.21, 0.69, NZ + 1))))


def _jax_fleet(fn, args, n):
    """JAX kernel on instance 0 (n = 1) or vmapped over the fleet."""
    args = tuple(jnp.asarray(a[:n]) for a in args)
    if n == 1:
        return jax.tree.map(lambda x: np.asarray(x)[None],
                            fn(*(a[0] for a in args)))
    return jax.tree.map(np.asarray, jax.vmap(fn)(*args))


SCALAR_JAX = {
    "lesflat": lambda *a: jflat.advect_diffuse_scalars(
        *a, JG.dx, JG.dy, JG.dz, bz=16, interpret=True),
    "advect": lambda *a: jadv.advect_diffuse_scalars(
        *a, JG.dx, JG.dy, JG.dz, interpret=True),
}


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("kernel", ["lesflat", "advect"])
def test_scalar_kernel_module_matches_jax_pallas(case, kernel, n):
    """The wrapper on CPU tensors (its plain version; no launch) == the
    Pallas kernel, one instance or JAX's vmapped fleet of 3."""
    names = ("u", "v", "w", "Ks", "scalars", "rhobf", "rhobh")
    ref = _jax_fleet(SCALAR_JAX[kernel], [case[k] for k in names], n)
    mod = {"lesflat": lesflat, "advect": tadv}[kernel]
    n0 = mod.launches
    got = mod.advect_diffuse_scalars(
        *(torch.tensor(case[k][:n]) for k in names), JG.dx, JG.dy, JG.dz)
    assert mod.launches == n0
    np.testing.assert_allclose(got.numpy(), ref, **SCALAR_TOL)


@pytest.mark.parametrize("n", [1, 3])
def test_momentum_kernel_module_matches_jax_pallas(case, n):
    """lesmom on CPU tensors (its plain version) == the Pallas kernel, with
    Km the first K field of the case."""
    args = [case[k] for k in ("u", "v", "w")] + [case["Ks"][:, 0]] + [
        case["rhobf"], case["rhobh"]]
    ref = _jax_fleet(lambda *a: jmom.momentum_tendencies(
        *a, JG.dx, JG.dy, JG.dz, interpret=True), args, n)
    n0 = lesmom.launches
    got = lesmom.momentum_tendencies(
        *(torch.tensor(a[:n]) for a in args), JG.dx, JG.dy, JG.dz)
    assert lesmom.launches == n0
    for name, a, b in zip(("du", "dv", "dw"), got, ref):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **MOM_TOL)


@pytest.mark.parametrize("entry", ["lesflat", "lesmom", "advect"])
def test_cuda_entries_refuse_cpu_tensors(case, entry):
    """The kernels' launch functions take CUDA tensors only; the check comes
    before any build, so it runs without nvcc."""
    t = {k: torch.tensor(v[:1]) for k, v in case.items()}
    sp = (JG.dx, JG.dy, JG.dz)
    with pytest.raises(ValueError, match="CUDA"):
        if entry == "lesmom":
            lesmom.momentum_tendencies_cuda(t["u"], t["v"], t["w"],
                                            t["Ks"][:, 0], t["rhobf"],
                                            t["rhobh"], *sp)
        else:
            mod = lesflat if entry == "lesflat" else tadv
            mod.advect_diffuse_scalars_cuda(t["u"], t["v"], t["w"], t["Ks"],
                                            t["scalars"], t["rhobf"],
                                            t["rhobh"], *sp)


@pytest.mark.parametrize("source, entry, argtypes", [
    ("lesflat", "lesflat_tend", lesflat._ARGTYPES),
    ("lesflat", "advect_tend", lesflat._ARGTYPES),
    ("lesmom", "lesmom_tend", lesmom._ARGTYPES)])
def test_c_entries_match_their_bindings(source, entry, argtypes):
    """Each C entry the wrappers call is defined once in its source, with
    as many parameters as the ctypes binding passes."""
    src = open("%s/%s.cu" % (_build.CSRC_DIR, source)).read()
    sigs = re.findall(r"\bint %s\(([^)]*)\)\s*\{" % entry, src)
    assert len(sigs) == 1
    assert len(sigs[0].split(",")) == len(argtypes)
    assert '#include "stencil.cuh"' in src


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    """A changed shared header makes a new build key for every source."""
    for f in ("lesflat.cu", "stencil.cuh"):
        (tmp_path / f).write_text(open("%s/%s" % (_build.CSRC_DIR, f)).read())
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    key = _build.source_key("lesflat")
    (tmp_path / "stencil.cuh").write_text("// changed\n")
    assert _build.source_key("lesflat") != key


# ---- the on-card check of kernels #2 and #3 must be able to fail ---------

def _below(f, axis):
    """f with level k holding level k-1 (edge-replicated at k = 0): a
    field read one level off."""
    lo = f.narrow(axis, 0, 1)
    return torch.cat([lo, f.narrow(axis, 0, f.shape[axis] - 1)], dim=axis)


def _swapped(plain, a, keys):
    """The plain version with every stencil offset's x and y swapped: the
    planes of the fields `keys` transposed, the plain version run, its
    output transposed back (needs nx == ny)."""
    T = lambda t: t.transpose(-1, -2).contiguous()
    out = plain(dict(a, **{k: T(a[k]) for k in keys}))
    return T(out) if torch.is_tensor(out) else tuple(T(x) for x in out)


def _mutants_scalars(a, g):
    """Plain versions of kernel #2 with one term removed, or with a fault
    of a tiled kernel: K read one level off, x and y swapped in the
    stencil."""
    u, v, w, Ks, sc, rf, rh = (a[k] for k in ("u", "v", "w", "Ks", "scalars",
                                              "rhobf", "rhobh"))
    z = torch.zeros_like
    stack = lambda f: torch.stack([f(sc[:, i], Ks[:, i]) for i in range(S)],
                                  dim=1)
    adv = lambda uu, vv, ww: stack(lambda s, K: advect.advect_scalar(
        g, rf, rh, uu, vv, ww, s, "hybrid52"))
    # rhobh = 0 in the diffusion leaves its horizontal part only
    dif = lambda rhh: stack(lambda s, K: subgrid.diffuse_scalar(
        g, rf, rhh, K, s))
    A, D, Dh = adv(u, v, w), dif(rh), dif(z(rh))
    plain = lambda b: lesflat.advect_diffuse_scalars_reference(
        *cs.scalar_args(b, g))
    return {"horizontal advection": adv(z(u), z(v), w) + D,
            "vertical advection": adv(u, v, z(w)) + D,
            "horizontal diffusion": A + D - Dh,
            "vertical diffusion": A + Dh,
            "K one level off": plain(dict(a, Ks=_below(Ks, 2))),
            "x and y swapped": _swapped(plain, a, ("u", "v", "w", "Ks",
                                                   "scalars"))}


def _mutants_momentum(a, g):
    """Plain versions of kernel #3 with one term or mask removed, or with a
    fault of a tiled kernel: Km read one level off, x and y swapped in
    the stencil."""
    u, v, w, Km, rf, rh = (a[k] for k in ("u", "v", "w", "Km", "rhobf",
                                          "rhobh"))
    z = torch.zeros_like
    nz = u.shape[1]
    du, dv, dw = lesmom.momentum_tendencies_reference(u, v, w, Km, rf, rh,
                                                      g.dx, g.dy, g.dz)
    # w = 0 leaves u's and v's horizontal advection; u = v = 0 leaves w's
    # vertical advection
    hu = advect.advect_u(g, rf, rh, u, v, z(w))
    hv = advect.advect_v(g, rf, rh, u, v, z(w))
    aw = advect.advect_w(g, rf, rh, u, v, w)
    vw = advect.advect_w(g, rf, rh, z(u), z(v), w)
    # rhobh = 0 (for w: rhobf = 0) leaves the diffusion's horizontal part
    hdu = subgrid.diffuse_scalar(g, rf, z(rh), Km, u)
    hdv = subgrid.diffuse_scalar(g, rf, z(rh), Km, v)
    hdw = subgrid.diffuse_w(g, z(rf), rh, Km, w)
    tu, tv = du - advect.advect_u(g, rf, rh, u, v, w), dv - \
        advect.advect_v(g, rf, rh, u, v, w)
    mut = {"horizontal advection": (du - hu, dv - hv, dw - aw + vw),
           "vertical advection": (hu + tu, hv + tv, dw - vw),
           "horizontal diffusion": (du - hdu, dv - hdv, dw - hdw),
           "vertical diffusion": (du - tu + hdu, dv - tv + hdv, aw + hdw),
           "w diffusion": (du, dv, aw)}
    # m0 off: face 0 keeps the value the kernel computes before the mask;
    # with w[0] = 0 only the vertical advection of w is left there
    wc = 0.5 * (w[:, 0] + w[:, 1])
    col = lambda p, k: p[:, k, None, None]
    dw0 = dw.clone()
    dw0[:, 0] = -(col(rf, 0) * wc * wc) / (col(rh, 0) * g.dz)
    mut["m0 mask"] = (du, dv, dw0)
    # fm off: the w-grid vertical diffusive flux at cells 0 and nz-1 kept
    Kc = lambda k: Km[:, min(max(k, 0), nz - 1)]
    Fd = lambda c: (-col(rf, c) * (0.25 * Kc(c - 1) + 0.5 * Kc(c)
                                   + 0.25 * Kc(c + 1))
                    * (w[:, c + 1] - w[:, c]) / g.dz)
    dwf = dw.clone()
    dwf[:, 1] += Fd(0) / (col(rh, 1) * g.dz)
    dwf[:, nz - 1] -= Fd(nz - 1) / (col(rh, nz - 1) * g.dz)
    mut["fm mask"] = (du, dv, dwf)
    plain = lambda b: lesmom.momentum_tendencies_reference(
        *cs.momentum_args(b, g))
    mut["K one level off"] = plain(dict(a, Km=_below(Km, 1)))
    mut["x and y swapped"] = _swapped(plain, a, ("u", "v", "w", "Km"))
    return mut


SMOKE_GRID = tgrid.LESGrid(nx=16, ny=16, nz=32)
SCALAR_TERMS = ("horizontal advection", "vertical advection",
                "horizontal diffusion", "vertical diffusion",
                "K one level off", "x and y swapped")
MOMENTUM_TERMS = SCALAR_TERMS + ("w diffusion", "m0 mask", "fm mask")


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py's inputs of kernels #2-#4 at 16x16x32, n = 2, and
    their plain versions' outputs."""
    a = cs.split_inputs(SMOKE_GRID, 2, 13, "cpu")
    g = SMOKE_GRID
    return dict(
        a=a,
        scalars=lesflat.advect_diffuse_scalars_reference(*cs.scalar_args(a, g)),
        momentum=lesmom.momentum_tendencies_reference(*cs.momentum_args(a, g)))


@pytest.mark.parametrize("kernel, term",
                         [("scalars", t) for t in SCALAR_TERMS]
                         + [("momentum", t) for t in MOMENTUM_TERMS])
def test_smoke_check_rejects_a_missing_term(smoke, kernel, term):
    g = SimpleNamespace(dx=SMOKE_GRID.dx, dy=SMOKE_GRID.dy, dz=SMOKE_GRID.dz)
    mutants = (_mutants_scalars if kernel == "scalars"
               else _mutants_momentum)(smoke["a"], g)
    tol = cs.SCALAR_TOL if kernel == "scalars" else cs.MOM_TOL
    with pytest.raises(AssertionError, match="out of tolerance"):
        cs.check_arrays(kernel, mutants[term], smoke[kernel], tol)


@pytest.mark.parametrize("kernel", ["scalars", "momentum"])
def test_smoke_check_accepts_float32_rounding(smoke, kernel):
    """The float32 plain version passes the check against its float64 run:
    the check is not tighter than rounding."""
    a64 = {k: v.double() for k, v in smoke["a"].items()}
    g = SMOKE_GRID
    if kernel == "scalars":
        ref = lesflat.advect_diffuse_scalars_reference(*cs.scalar_args(a64, g))
        tol = cs.SCALAR_TOL
    else:
        ref = lesmom.momentum_tendencies_reference(*cs.momentum_args(a64, g))
        tol = cs.MOM_TOL
    got = smoke[kernel]
    got = got.double() if torch.is_tensor(got) else [x.double() for x in got]
    fracs = cs.check_arrays(kernel, got, ref, tol)
    assert max(fracs) < 0.1 * cs.ARRAY_FRAC


@pytest.fixture(scope="module")
def rough():
    """chip_smoke.py's rough inputs of kernels #2-#4 at 16x16x32, n = 2
    (s and K per point, u and v of both signs with zero faces), and their
    plain versions' outputs."""
    a = cs.rough_split_inputs(SMOKE_GRID, 2, 13, "cpu")
    g = SMOKE_GRID
    return dict(
        a=a,
        scalars=lesflat.advect_diffuse_scalars_reference(*cs.scalar_args(a, g)),
        momentum=lesmom.momentum_tendencies_reference(*cs.momentum_args(a, g)))


@pytest.mark.parametrize("kernel, term",
                         [("scalars", t) for t in SCALAR_TERMS]
                         + [("momentum", t) for t in MOMENTUM_TERMS])
def test_rough_check_rejects_a_missing_term(rough, kernel, term):
    """The on-card check fails each mutant on the rough input too."""
    g = SimpleNamespace(dx=SMOKE_GRID.dx, dy=SMOKE_GRID.dy, dz=SMOKE_GRID.dz)
    mutants = (_mutants_scalars if kernel == "scalars"
               else _mutants_momentum)(rough["a"], g)
    tol = cs.SCALAR_TOL if kernel == "scalars" else cs.MOM_TOL
    with pytest.raises(AssertionError, match="out of tolerance"):
        cs.check_arrays(kernel, mutants[term], rough[kernel], tol)


def test_rough_input_is_rough():
    """rough_split_inputs gives u and v of both signs with exact zeros (the
    upwind face's sign(0) == 0), and s and K varying per point."""
    a = cs.rough_split_inputs(SMOKE_GRID, 2, 13, "cpu")
    b = cs.split_inputs(SMOKE_GRID, 2, 13, "cpu")
    for k in ("u", "v"):
        assert (a[k] > 0).any() and (a[k] < 0).any() and (a[k] == 0).any()
    for k in ("scalars", "Ks", "Km"):
        nz = b[k] != 0
        assert float((a[k][nz] / b[k][nz]).std()) > 1e-3


class _FakeProfile:
    """Stand-in for torch.profiler.profile: each capture yields the next
    list of (kernel name, us) device records."""

    captures = []

    def __init__(self, activities):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        ev = lambda name, us: SimpleNamespace(
            name=name, device_type=torch.autograd.DeviceType.CUDA,
            time_range=SimpleNamespace(elapsed_us=lambda: us))
        return [ev(n, us) for n, us in _FakeProfile.captures.pop(0)]


def test_device_us_times_the_launches_it_sees(monkeypatch):
    """chip_smoke.device_us: a kernel missing one record of 20 is timed by
    the 19 it shows; a capture without an expected kernel is taken again;
    a kernel launched twice a call counts twice; three captures without
    it raise."""
    import torch.profiler
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    _FakeProfile.captures = [
        [("k_means", 5.0)] * 20,                                # no k_stage
        [("k_means", 5.0)] * 20 + [("k_stage", 40.0)] * 19
        + [("fill", 1.0)] * 40]
    got = cs.device_us(lambda: None, expect=("k_means", "k_stage"))
    assert got == {"k_means": 5.0, "k_stage": 40.0, "fill": 2.0}
    _FakeProfile.captures = [[("k_means", 5.0)] * 20] * 3
    with pytest.raises(RuntimeError, match="not each of"):
        cs.device_us(lambda: None, expect=("k_stage",))
