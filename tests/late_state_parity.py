"""The port against the JAX package on the CPU, from an LES state a coupled
run on the card reached: ``python -m sp_coupler_tpu_torch.verify.late_state
cut``'s npz (the raining instance of config 2 at a leg join, its forcing,
the dts its adaptive loop took in the next step, the GCM state and the
SP tendencies of that step).

    JAX_PLATFORMS=cpu python tests/late_state_parity.py CUT.npz \\
        [--parts stage,substeps,evolve,gcm] [--substeps 100] [--out R.json]
    JAX_PLATFORMS=cpu python tests/late_state_parity.py CUT.npz --x64 \\
        --parts stage64 --witness W.npz
    JAX_PLATFORMS=cpu python tests/late_state_parity.py CUT.npz \\
        --parts stage --witness W.npz

Three implementations of the LES: the JAX package's plain path (``jax``),
its Pallas stage kernel in interpret mode (``pallas``, as tests/test_ops.py
runs it) and the port's plain path (``port``: its stage kernel's plain
version, what the kernel is held to on the card), at three depths:

- ``stage``: one RK stage (frac 1/3, base = the state, the first dt of the
  card's loop), pointwise at tests/test_torch_ops.py's stage tolerances,
  and the increments from chip_smoke's base of constants at INC_FRAC of
  their max;
- ``substeps``: SUBSTEPS substeps at a fixed dt, the smallest of the
  card's first SUBSTEPS dts (the flow stays inside its CFL limit),
  pointwise at SUBSTEP_FRAC of each field's max (tests/test_torch_ops.py's
  one-substep tolerance, stated before the run);
- ``evolve``: one whole adaptive evolve of the 900 s GCM step (JAX plain
  and the port; the Pallas path's interpret mode is not run that long):
  the slab means of U, V, THL, QT, QL, QR and T held at
  verify/parity.py's PROFILE_TOL[0] of each profile's max and the
  substep counts equal;

``stage64`` (run alone, under ``--x64``): JAX plain's stage from the base
of constants in float64 on the float32 inputs, the witness of float64 that
does not come from the port: against it the port's plain version in
float64 (formula against formula) and the stability N^2 of both in
float64; its increments go to ``--witness``, where a later ``stage`` part
holds each float32 path's increments against them;

and ``gcm``: one T21 GCM step (phase A, the cloud scheme, the step's SP
tendencies, phase B) from the checkpoint's GCM state, JAX against the
port at tests/test_torch_gcm.py's tolerances (column profiles rtol 1e-4
+ 1e-5 max|ref|; every state leaf rtol 1e-3 + 1e-4 max|ref|).

Every comparison's worst error goes to the report, pass or fail; the
script exits 1 if any part failed. It is not a test (JAX takes ~1 s a
substep at 64x64x160 here): tests/test_torch_late_state.py holds the
same comparisons on a small raining state built by construction.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from sp_coupler_tpu.models.gcm import model as jmodel  # noqa: E402
from sp_coupler_tpu.models.gcm import physics as jphysics  # noqa: E402
from sp_coupler_tpu.models.les import (diag as jdiag, grid as jgrid,  # noqa
                                       micro as jmicro, state as jstate,
                                       step as jstep, subgrid as jsg)
from sp_coupler_tpu.ops import lesstage_pallas as jls  # noqa: E402
from sp_coupler_tpu_torch import interop  # noqa: E402
from sp_coupler_tpu_torch.models.gcm import model as tmodel  # noqa: E402
from sp_coupler_tpu_torch.models.les import (diag as tdiag,  # noqa: E402
                                             grid as tgrid, step as tstep)
from sp_coupler_tpu_torch.models.les.state import (LESForcing,  # noqa: E402
                                                   LESState)
from sp_coupler_tpu_torch.ops import lesstage  # noqa: E402
from sp_coupler_tpu_torch.verify import late_state, parity  # noqa: E402

NAMES = ("u", "v", "w", "thl", "qt", "qr", "e12")
FRAC = 1.0 / 3.0
FIELD_TOL = dict(atol=5e-4, rtol=1e-4)      # tests/test_torch_ops.py
SUBSTEPS = 100
SUBSTEP_FRAC = 2e-3                         # of each field's max, + rtol
PROFILES = ("U", "V", "THL", "QT", "QL", "QR", "T")
PROFILE_TOL = parity.PROFILE_TOL[0]
GCM_PROFILE_TOL = (1e-4, 1e-5)              # rtol, atol of max|ref|
GCM_LEAF_TOL = (1e-3, 1e-4)


def case(path):
    """(info, JAX grid, phys of each path, port grid and phys, the
    instance as JAX state/forcing and port state/forcing, the card's dts,
    the arrays)."""
    arrays, info = late_state.load(path)
    g = info["grid"]
    jg, tg = jgrid.LESGrid(**g), tgrid.LESGrid(**g)
    phys = dict(info["phys"])
    mp = phys.pop("mphys")
    phys.pop("use_kernel")
    jphys = lambda pallas: jstep.LESPhysics(
        **phys, mphys=jmicro.MicroParams(**mp), use_pallas=pallas)
    tphys = late_state.les_physics(info)
    ts, tf = late_state.les_inputs(arrays, "cpu")
    js = jstate.LESState(*[jnp.asarray(arrays["les_" + k][0])
                           for k in LESState._fields])
    jf = jstate.LESForcing(*[jnp.asarray(arrays["frc_" + k][0])
                             for k in LESForcing._fields])
    return dict(info=info, jg=jg, tg=tg, jphys=jphys, tphys=tphys, js=js,
                jf=jf, ts=ts, tf=tf, dts=arrays["dts"], arrays=arrays)


def worst(a, b, scale=None):
    """max|a - b| and, with a scale, over it."""
    d = float(np.max(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64))))
    return d if scale is None else d / max(scale, 1e-30)


def held(a, b, atol, rtol):
    a, b = np.asarray(a), np.asarray(b)
    return bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b)))


def jax_plain_stage(c, cur, base, dt):
    t = jstep.tendencies(c["jg"], c["jphys"](False), cur, c["jf"], dt)
    f = FRAC * dt
    out = (base.u + f * t["u"], base.v + f * t["v"],
           (base.w + f * t["w"])[:-1], base.thl + f * t["thl"],
           jnp.maximum(base.qt + f * t["qt"], 0.0),
           jnp.maximum(base.qr + f * t["qr"], 0.0),
           jnp.maximum(base.e12 + f * t["e12"], jsg.E12_MIN))
    return out + (t["kmax"], jnp.mean(t["ustar"] ** 2), t["surf_rain"])


def stage_part(c):
    """One stage through the three paths, from the state and from the
    base of constants; every pair against JAX plain."""
    dt = float(c["dts"][0])
    out = {}
    for base_name in ("state", "constants"):
        tb = c["ts"] if base_name == "state" else cs.increment_base(c["ts"])
        jb = jstate.LESState(*[jnp.asarray(x.numpy()[0]) for x in tb])
        runs = dict(
            jax=jax.jit(lambda cur, b: jax_plain_stage(c, cur, b, dt))(
                c["js"], jb),
            pallas=jls.stage_fused(c["jg"], c["jphys"](True), c["js"], jb,
                                   c["jf"], FRAC, jnp.float32(dt)),
            port=[x.numpy()[0] for x in lesstage.stage_fused_reference(
                c["tg"], c["tphys"], c["ts"], tb, c["tf"], FRAC,
                torch.tensor([dt]))])
        ref = [np.asarray(x) for x in runs["jax"]]
        for name in ("pallas", "port"):
            got = [np.asarray(x) for x in runs[name]]
            r = dict(fields={}, ok=True)
            for k, a, b in zip(NAMES, got[:7], ref[:7]):
                e = dict(max_abs=worst(a, b),
                         ok=held(a, b, FIELD_TOL["atol"], FIELD_TOL["rtol"]))
                if base_name == "constants":
                    bk = getattr(tb, k).numpy()[0]
                    bk = bk[:-1] if k == "w" else bk
                    sc = float(np.abs(b - bk).max())
                    e["increment_rel"] = worst(a - bk, b - bk, sc)
                    e["ok"] &= held(a - bk, b - bk, cs.INC_FRAC * sc,
                                    cs.INC_RTOL)
                r["fields"][k] = e
                r["ok"] &= e["ok"]
            for k, i, rtol, atol in (("kmax", 7, 1e-4, 0.0),
                                     ("ustar2", 8, 1e-3, 0.0),
                                     ("rain", 9, 1e-3, 1e-10)):
                r[k] = dict(rel=worst(got[i], ref[i], abs(float(ref[i]))),
                            ok=held(got[i], ref[i], atol, rtol))
                r["ok"] &= r[k]["ok"]
            out["%s_vs_jax_base_%s" % (name, base_name)] = r
        if base_name == "constants":
            out["increments_vs_float64"] = increments_vs_float64(
                c, tb, dt, dict(runs, jax=ref))
            if c.get("witness"):
                out["increments_vs_jax_float64"] = increments_vs_witness(
                    c, tb, dict(runs, jax=ref))
    out["n2_vs_float64"] = n2_vs_float64(c)
    return out


def increments_vs_witness(c, tb, runs):
    """Each float32 path's stage increments (from the base of constants
    tb) off JAX plain's in float64 (``stage64``'s witness file), over each
    increment's max."""
    with np.load(c["witness"]) as w:
        ref = {k: w[k] for k in NAMES}
    out = {}
    for name, got in runs.items():
        got = [np.asarray(x) for x in got]
        out[name] = {}
        for i, k in enumerate(NAMES):
            bk = getattr(tb, k).numpy()[0]
            bk = bk[:-1] if k == "w" else bk
            out[name][k] = worst(got[i] - bk, ref[k],
                                 float(np.abs(ref[k]).max()))
    return out


def stage64_part(c):
    """JAX plain's stage from the base of constants in float64 (the process
    under jax_enable_x64) on the float32 inputs cast up; its increments
    against the port's plain version in float64, and N^2 of both in
    float64. Writes the increments to the witness file."""
    from sp_coupler_tpu.models.les import step as jst, subgrid as jsub
    from sp_coupler_tpu_torch.models.les import subgrid as tsub
    if not jax.config.jax_enable_x64:
        raise SystemExit("stage64: run with --x64")
    dt = float(c["dts"][0])
    tb = cs.increment_base(c["ts"])
    up = lambda t: type(t)(*[jnp.asarray(np.asarray(x), jnp.float64)
                             for x in t])
    js = up(c["js"])
    jb = up(jstate.LESState(*[x.numpy()[0] for x in tb]))
    c64 = dict(c, jf=up(c["jf"]))
    j64 = [np.asarray(x) for x in jax.jit(
        lambda cur, b: jax_plain_stage(c64, cur, b, dt))(js, jb)]
    if j64[0].dtype != np.float64:
        raise AssertionError("stage64: JAX ran in %s" % j64[0].dtype)
    p64 = [x.numpy()[0] for x in cs.stage_reference(
        c["tg"], c["tphys"], c["ts"], tb, c["tf"], FRAC,
        torch.tensor([dt]), f64=True)]
    inc, out = {}, dict(port64_vs_jax64={})
    for i, k in enumerate(NAMES):
        bk = getattr(tb, k).numpy()[0].astype(np.float64)
        bk = bk[:-1] if k == "w" else bk
        inc[k] = j64[i] - bk
        out["port64_vs_jax64"][k] = worst(p64[i] - bk, inc[k],
                                          float(np.abs(inc[k]).max()))
    np.savez(c["witness"], **inc)
    n64 = tsub.tke_viscosity(c["tg"], cs.as_f64(c["ts"]), tstep.thermodynamics(
        cs.as_f64(c["ts"]))[3])[4].numpy()[0, :, 0, 0]
    nj = np.asarray(jsub.tke_viscosity(c["jg"], js, jst.thermodynamics(js)[3])
                    [4])[:, 0, 0]
    rel = np.abs(n64 - nj) / np.maximum(np.abs(nj), 1e-30)
    out["n2_port64_vs_jax64"] = dict(max=float(rel.max()),
                                     level=int(np.argmax(rel)))
    return out


def increments_vs_float64(c, tb, dt, runs):
    """Each path's stage increments (from the base of constants tb) off
    the port's plain version run in float64 on the same float32 inputs,
    over each increment's max: where two float32 paths part, which one
    float64 sides with."""
    f64 = [x.numpy()[0] for x in cs.stage_reference(
        c["tg"], c["tphys"], c["ts"], tb, c["tf"], FRAC,
        torch.tensor([dt]), f64=True)]
    out = {}
    for name, got in runs.items():
        got = [np.asarray(x) for x in got]
        out[name] = {}
        for i, k in enumerate(NAMES):
            bk = getattr(tb, k).numpy()[0]
            bk = bk[:-1] if k == "w" else bk
            ref = f64[i] - bk
            out[name][k] = worst(got[i] - bk, ref, float(np.abs(ref).max()))
    return out


def n2_vs_float64(c):
    """The Deardorff closure's stability N^2 (a slab-mean thv gradient, one
    value a level) of the port and of the JAX package in float32 against
    the port's in float64: the largest relative error and its level, and
    the median over the levels. Near-neutral levels make N^2 a small
    difference of ~300 K values, where float32 loses percents."""
    from sp_coupler_tpu.models.les import step as jst, subgrid as jsub
    from sp_coupler_tpu_torch.models.les import subgrid as tsub

    def port(s):
        thv = tstep.thermodynamics(s)[3]
        return tsub.tke_viscosity(c["tg"], s, thv)[4].numpy()[0, :, 0, 0]
    n64 = port(cs.as_f64(c["ts"]))
    js = c["js"]
    nj = np.asarray(jsub.tke_viscosity(c["jg"], js, jst.thermodynamics(js)[3])
                    [4])[:, 0, 0]
    out = dict(n2_float64_min=float(np.abs(n64).min()))
    for name, n32 in (("port", port(c["ts"])), ("jax", nj)):
        rel = np.abs(n32 - n64) / np.maximum(np.abs(n64), 1e-30)
        out[name] = dict(max=float(rel.max()), level=int(np.argmax(rel)),
                         median=float(np.median(rel)))
    return out


def state_errors(got, ref, frac):
    """{field: max|got - ref| / max|ref|} and whether every field lies
    within frac x max|ref| + frac x |ref|."""
    res, ok = {}, True
    for f in NAMES + ("rain", "ustar", "time"):
        a, b = np.asarray(got[f]), np.asarray(ref[f])
        sc = float(np.abs(b).max())
        res[f] = worst(a, b, sc)
        ok &= held(a, b, frac * sc, frac)
    return res, ok


def substeps_part(c, n=SUBSTEPS):
    dts = c["dts"][:n]
    dt = float(dts.min())
    runs = {}
    for name in ("jax", "pallas"):
        phys = c["jphys"](name == "pallas")
        one = jax.jit(lambda s: jstep.substep(c["jg"], phys, s, c["jf"],
                                              jnp.float32(dt)))
        t0, s = time.time(), c["js"]
        for _ in range(n):
            s, k = one(s)
        jax.block_until_ready(s)
        runs[name] = ({f: np.asarray(getattr(s, f)) for f in LESState._fields},
                      float(k), time.time() - t0)
        print("substeps: %s %d in %.1f s" % (name, n, runs[name][2]),
              flush=True)
    t0, s = time.time(), c["ts"]
    for _ in range(n):
        s, k = tstep.substep(c["tg"], c["tphys"], s, c["tf"],
                             torch.tensor([dt]))
    runs["port"] = ({f: getattr(s, f).numpy()[0] for f in LESState._fields},
                    float(k[0]), time.time() - t0)
    out = dict(n=n, dt=dt, tol_frac=SUBSTEP_FRAC,
               seconds={k: v[2] for k, v in runs.items()})
    ref = runs["jax"][0]
    for name in ("pallas", "port"):
        res, ok = state_errors(runs[name][0], ref, SUBSTEP_FRAC)
        kmax = worst(runs[name][1], runs["jax"][1], runs["jax"][1])
        out["%s_vs_jax" % name] = dict(rel=res, kmax_rel=kmax,
                                       ok=ok and kmax <= 1e-3)
    res, ok = state_errors(runs["port"][0], runs["pallas"][0], SUBSTEP_FRAC)
    out["port_vs_pallas"] = dict(rel=res, ok=ok)
    return out


def evolve_part(c):
    ev = c["info"]["evolve"]
    kw = dict(dt_max=ev["dt_max"], cfl=ev["cfl"], dt_min=ev["dt_min"],
              peclet=ev["peclet"])
    t_end = float(c["arrays"]["t_end"][0])
    t0 = time.time()
    js, jn, jc = jax.jit(lambda s: jstep.evolve_adaptive(
        c["jg"], c["jphys"](False), s, c["jf"], jnp.float32(t_end),
        **kw))(c["js"])
    jax.block_until_ready(js)
    t_jax = time.time() - t0
    print("evolve: jax %d substeps in %.1f s" % (int(jn), t_jax), flush=True)
    t0 = time.time()
    ts, tn, tc = tstep.evolve_adaptive(c["tg"], c["tphys"], c["ts"], c["tf"],
                                       torch.tensor([t_end]), **kw)
    t_port = time.time() - t0
    print("evolve: port %d substeps in %.1f s" % (int(tn[0]), t_port),
          flush=True)
    pj = jdiag.slab_profiles(c["jg"], js)
    pt = tdiag.slab_profiles(c["tg"], ts)
    card = {k: c["arrays"]["card_" + k][0] for k in PROFILES}
    out = dict(substeps=dict(jax=int(jn), port=int(tn[0]),
                             card=int(c["arrays"]["n_substeps"][0])),
               clamped=dict(jax=int(jc), port=int(tc[0])),
               seconds=dict(jax=t_jax, port=t_port), tol=PROFILE_TOL,
               port_vs_jax={}, card_vs_jax={})
    ok = int(jn) == int(tn[0])
    for k in PROFILES:
        ref = np.asarray(pj[k])
        sc = float(np.abs(ref).max())
        out["port_vs_jax"][k] = worst(pt[k].numpy()[0], ref, sc)
        out["card_vs_jax"][k] = worst(card[k], ref, sc)
        ok &= out["port_vs_jax"][k] <= PROFILE_TOL
    out["ok"] = bool(ok)
    return out


def gcm_part(c):
    """One GCM step from the checkpoint's state with the step's SP
    tendencies, JAX against the port."""
    a, info = c["arrays"], c["info"]
    g = dict(info["gcm"])
    phys = g.pop("phys")
    jc = jmodel.GCMCore(jmodel.GCMConfig(
        **g, phys=jphysics.PhysicsParams(**phys)))
    tc = tmodel.GCMCore(tmodel.GCMConfig(
        **g, phys=type(tmodel.GCMConfig().phys)(**phys)), device="cpu")
    leaves = [a["gcm_%d" % i] for i in range(
        len([k for k in a if k.startswith("gcm_")]))]
    treedef = jax.tree.structure(jc.initial_state(seed=0))
    gj = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
    gt = interop.gcm_state(jax.tree.map(np.asarray, gj), "cpu")
    cols = a["cols"]
    tend = {k[5:]: a[k] for k in a if k.startswith("tend_")}
    gj = jc._phase_a_body(gj, False)
    gt = tc.phase_a(gt, False)
    cloud64 = cloud_in_float64(tc, gj, gt)
    gj = jc.phase_cloud(gj)
    gt = tc.phase_cloud(gt)
    gj = jc.with_sp_tendencies(gj, jnp.asarray(cols),
                               {k: jnp.asarray(v) for k, v in tend.items()})
    gt = tc.with_sp_tendencies(gt, torch.as_tensor(cols),
                               {k: torch.as_tensor(v) for k, v in
                                tend.items()})
    out = dict(profiles={}, leaves={}, ok=True, cloud_float64=cloud64)
    a32 = [np.asarray(gj.grid.a), gt.grid.a.numpy()]
    out["cloud_float64"]["a_float32_rel"] = worst(
        a32[1], a32[0], float(np.abs(a32[0]).max()))
    pj = jc.column_profiles(gj, jnp.asarray(cols))
    pt = tc.column_profiles(gt, torch.as_tensor(cols))
    for k in pj:
        ref = np.asarray(pj[k])
        sc = float(np.abs(ref).max())
        out["profiles"][k] = worst(pt[k].numpy(), ref, sc)
        if not held(pt[k].numpy(), ref, GCM_PROFILE_TOL[1] * sc,
                    GCM_PROFILE_TOL[0]):
            out["ok"] = False
            out.setdefault("outside", []).append("profile " + k)
    gj = jc._phase_b_body(gj, False)
    gt = tc._phase_b_body(gt, False)
    # tests/test_torch_gcm.py::_leaves: both trees through to_numpy
    lj = jax.tree.leaves(interop.to_numpy(jax.tree.map(np.asarray, gj)))
    lt = jax.tree.leaves(interop.to_numpy(gt))
    assert len(lj) == len(lt)
    for i, (x, y) in enumerate(zip(lt, lj)):
        sc = float(np.abs(y).max())
        out["leaves"][i] = worst(x, y, sc)
        if not held(x, y, GCM_LEAF_TOL[1] * sc, GCM_LEAF_TOL[0]):
            out["ok"] = False
            out.setdefault("outside", []).append("leaf %d" % i)
    out["worst_leaf"] = max(out["leaves"].values())
    out["worst_profile"] = max(out["profiles"].values())
    return out


def cloud_in_float64(tc, gj, gt):
    """The cloud scheme (the port's formula, the JAX package's copy) in
    float64 on each side's state after phase A: how far apart the two
    sides' inputs put the cloud fraction a where no float32 rounding of
    the scheme itself enters. Near saturation a = 1 - sqrt((1 - RH) /
    (1 - RHcrit)) has an unbounded slope in RH, so a float32 difference of
    RH is multiplied there."""
    from sp_coupler_tpu_torch import constants as tconst
    from sp_coupler_tpu_torch.models.gcm import physics as tphysics
    outs = []
    for g in (interop.gcm_state(jax.tree.map(np.asarray, gj), "cpu").grid,
              gt.grid):
        d = lambda x: x.double()
        ph = d(tc.vc.A)[:, None, None] + d(tc.vc.B)[:, None, None] * (
            tconst.pref0 * torch.exp(d(g.lnps)))[None]
        pf = 0.5 * (ph[1:] + ph[:-1])
        outs.append(tphysics.cloud_scheme(
            d(g.T), d(g.q).clamp_min(0.0), d(g.ql).clamp_min(0.0),
            d(g.qi).clamp_min(0.0), d(g.a).clamp(0.0, 1.0), pf,
            tc.cfg.dt, tc.cfg.phys)[4].numpy())
    # both packages' float32 schemes on the same inputs (JAX's state)
    from sp_coupler_tpu.models.gcm import physics as jphys_mod
    g = gj.grid
    pf = tc.vc.pressures(tconst.pref0 * torch.exp(
        torch.from_numpy(np.asarray(g.lnps))))[1]
    args = [np.asarray(x) for x in (g.T, jnp.maximum(g.q, 0.0),
                                    jnp.maximum(g.ql, 0.0),
                                    jnp.maximum(g.qi, 0.0),
                                    jnp.clip(g.a, 0.0, 1.0))]
    aj = np.asarray(jphys_mod.cloud_scheme(
        *[jnp.asarray(x) for x in args], jnp.asarray(pf.numpy()),
        tc.cfg.dt, jphys_mod.PhysicsParams(**tc.cfg.phys._asdict()))[4])
    at = tphysics.cloud_scheme(*[torch.from_numpy(x) for x in args], pf,
                               tc.cfg.dt, tc.cfg.phys)[4].numpy()
    sc = float(np.abs(outs[0]).max())
    return dict(a_float64_rel=worst(outs[1], outs[0], sc),
                a_same_inputs_rel=worst(at, aj, sc),
                a_port_vs_float64_rel=worst(at, outs[0], sc),
                a_jax_vs_float64_rel=worst(aj, outs[0], sc))


PARTS = dict(stage=stage_part, substeps=substeps_part, evolve=evolve_part,
             gcm=gcm_part, stage64=stage64_part)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cut")
    p.add_argument("--parts", default="stage,substeps,evolve,gcm")
    p.add_argument("--substeps", type=int, default=SUBSTEPS)
    p.add_argument("--out", default=None)
    p.add_argument("--x64", action="store_true",
                   help="JAX in float64 (for the stage64 part alone)")
    p.add_argument("--witness", default=None,
                   help="stage64 writes JAX's float64 increments here; "
                        "stage holds the float32 paths against them")
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    c = case(args.cut)
    c["witness"] = args.witness
    info = c["info"]
    report = dict(cut=os.path.basename(args.cut), step=info["step"],
                  column=info["column"], seed=info["seed"],
                  card=info["card"], dt_first=info["dt_first"],
                  torch_threads=torch.get_num_threads())
    for name in args.parts.split(","):
        t0 = time.time()
        kw = dict(n=args.substeps) if name == "substeps" else {}
        report[name] = PARTS[name](c, **kw)
        report[name]["wall_s"] = time.time() - t0
        print("%s: %s" % (name, json.dumps(report[name])), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
    bad = [k for k in args.parts.split(",") if not part_ok(report[k])]
    print("late-state parity: %s" % ("FAILED: " + ", ".join(bad) if bad
                                      else "all parts hold"))
    return 1 if bad else 0


def part_ok(r):
    return all(v["ok"] for v in r.values() if isinstance(v, dict)
               and "ok" in v) and r.get("ok", True)


if __name__ == "__main__":
    sys.exit(main())
