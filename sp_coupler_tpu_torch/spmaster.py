"""Experiment driver CLI of the PyTorch port.

Run as ``python -m sp_coupler_tpu_torch.spmaster``. The same surface as
the JAX package's ``spmaster.py`` (and the reference's): region selection
from points / polygons / geoJSON, model-type switches, spinup, restart,
surface coupling and qt-forcing flags, @argfile support, the same
precedence (defaults < input decks < --conf JSON < explicit flags) and the
one-step overlap on the step count for restarts (spmaster.py:267). Beside
them, --device names the torch device; without it the run takes the CUDA
card, and fails where there is none.

Several processes, one a slot of the LES instance axis (``--mesh_les``
N): ``torchrun --nproc_per_node N -m sp_coupler_tpu_torch.spmaster
--mesh_les N ...``, or N processes with ``SPTPU_DIST_COORD`` (host:port),
``SPTPU_DIST_NPROCS`` and ``SPTPU_DIST_PROC_ID`` set. On the card each
rank takes its own card (nccl); ``SPTPU_DIST_BACKEND=gloo`` lets ranks
share one.
"""

import argparse
import json
import logging
import os
import sys

from sp_coupler_tpu_torch.config import SPConfig, read_config
from sp_coupler_tpu_torch.parallel import mesh as pmesh
from sp_coupler_tpu_torch.utils import decks, geometry
from sp_coupler_tpu_torch.runtime.driver import SPRunner

log = logging.getLogger(__name__)

GCM_TYPES = ["sptpu", "oifs", "dummy", "ncfile"]
LES_TYPES = ["sptpu", "dales", "dummy", "ncfile"]
SUMMARY = "run summary: "


def readable_dir(dirname):
    if not dirname:
        return dirname   # unset default: the native models need no deck dir
    if not os.path.isdir(dirname):
        raise argparse.ArgumentTypeError("%s is not a directory" % dirname)
    if not os.access(dirname, os.R_OK):
        raise argparse.ArgumentTypeError("%s is not readable" % dirname)
    return dirname


def build_parser(defaults: SPConfig):
    p = argparse.ArgumentParser(
        description="GCM-LES superparametrization run script (PyTorch)",
        fromfile_prefix_chars="@")
    p.add_argument("--steps", dest="gcm_steps", metavar="N", type=int,
                   default=defaults.gcm_steps, help="Nr. of (GCM) time steps")
    p.add_argument("--conf", dest="conf", metavar="FILE.json", type=str,
                   default=None, help="Configuration file")
    p.add_argument("--lesdir", dest="les_input_dir", metavar="DIR",
                   type=readable_dir, default=defaults.les_input_dir,
                   help="LES input directory")
    p.add_argument("--lestype", dest="les_type", metavar="TYPE",
                   choices=LES_TYPES, default=defaults.les_type,
                   help="LES model type")
    p.add_argument("--les_dt", dest="les_dt", metavar="dt", type=float,
                   default=defaults.les_dt,
                   help="LES max substep (s); <0 = auto from CFL. "
                        "DEVIATION from the reference: there --les_dt is "
                        "the DALES statistics save interval (reference "
                        "spmaster.py:113-117); here the native LES "
                        "substep cap (statistics cadence is set by "
                        "--les_cross_dtav)")
    p.add_argument("--spinup", dest="les_spinup", metavar="T", type=float,
                   default=defaults.les_spinup,
                   help="LES spinup time before the GCM start (s)")
    p.add_argument("--spinup_steps", dest="les_spinup_steps", metavar="N",
                   type=int, default=defaults.les_spinup_steps,
                   help="Number of spinup nudging iterations")
    p.add_argument("--spinup_forcing", dest="les_spinup_forcing_factor",
                   metavar="f", type=float,
                   default=defaults.les_spinup_forcing_factor,
                   help="Forcing strength during LES spinup")
    p.add_argument("--gcmdir", dest="gcm_input_dir", metavar="DIR",
                   type=readable_dir, default=defaults.gcm_input_dir,
                   help="GCM input directory")
    p.add_argument("--gcmtype", dest="gcm_type", metavar="TYPE",
                   choices=GCM_TYPES, default=defaults.gcm_type,
                   help="GCM model type")
    p.add_argument("--gcmexp", dest="gcm_exp_name", metavar="NAME", type=str,
                   default=defaults.gcm_exp_name, help="GCM experiment name")
    p.add_argument("--trunc", dest="gcm_truncation", metavar="T", type=int,
                   default=defaults.gcm_truncation,
                   help="GCM spectral truncation (21 = T21)")
    p.add_argument("--levels", dest="gcm_levels", metavar="L", type=int,
                   default=defaults.gcm_levels, help="GCM vertical levels")
    p.add_argument("--gcm_advection", dest="gcm_advection", metavar="SCHEME",
                   type=str, default="auto", choices=["auto", "eulerian",
                                                      "sl"],
                   help="GCM advection: semi-Lagrangian (sl, the OpenIFS-"
                        "lineage large-timestep scheme), Eulerian leapfrog,"
                        " or auto (sl at T63+)")
    p.add_argument("--gcm_dt", dest="gcm_dt", metavar="dt", type=float,
                   default=defaults.gcm_dt, help="GCM time step (s)")
    p.add_argument("--odir", dest="output_dir", metavar="DIR", type=str,
                   default=defaults.output_dir, help="Output directory")
    p.add_argument("--dryrun", action="store_true", default=False,
                   help="Only initialize the GCM and save grid points")
    p.add_argument("--points", metavar="lat1 lon1 ... latn lonn", nargs="+",
                   default="", help="lat/lon pairs for SP columns")
    p.add_argument("--poly", metavar="lat1 lon1 ... latn lonn", nargs="+",
                   default="", help="polygon corners for the SP region")
    p.add_argument("--polyfile", metavar="filename", default=None,
                   help="geoJSON polygon for superparameterization")
    p.add_argument("--output_poly", metavar="lat1 lon1 ...", nargs="+",
                   default="", help="polygon for extra output columns")
    p.add_argument("--output_polyfile", metavar="filename", default=None,
                   help="geoJSON polygon for statistics output")
    p.add_argument("-a", "--all", action="store_true", default=False,
                   help="Superparametrize all GCM grid columns")
    p.add_argument("--numles", dest="max_num_les", metavar="N", type=int,
                   default=defaults.max_num_les,
                   help="Max LES instances / closest-N for point selection")
    p.add_argument("--restart", action="store_true", default=False,
                   help="Restart an old run")
    p.add_argument("--restart_overlap", action="store_true", default=False,
                   help="Write the checkpoint after --steps steps, before "
                        "the overlap step, and none at the end: a run "
                        "resumed from it (--restart) recomputes the overlap "
                        "step and writes on from the next, so legs of "
                        "--steps L1, L2, ... hold the records of one run "
                        "of --steps L1 + L2 + ...")
    p.add_argument("--restart_steps", dest="restart_steps", metavar="N",
                   type=int, default=defaults.restart_steps,
                   help="Save a restart checkpoint every N steps "
                        "(0 = only at finalize)")
    p.add_argument("--cplsurf", dest="cplsurf", action="store_true",
                   default=False,
                   help="Couple surface fluxes and roughness lengths")
    p.add_argument("--qt_forcing", dest="qt_forcing", metavar="TYPE",
                   choices=["sp", "variance", "local", "strong"],
                   default=defaults.qt_forcing, help="qt forcing type")
    p.add_argument("--conservative_coarsening",
                   dest="conservative_coarsening", action="store_true",
                   default=False,
                   help="Conservative (rho-weighted integral) LES->GCM "
                        "remapping instead of linear interpolation")
    p.add_argument("--variability_nudge_constant_T",
                   dest="variability_nudge_constant_T", action="store_true",
                   default=False,
                   help="nudge qt variability at constant T "
                        "(when qt_forcing=variance)")
    p.add_argument("--mesh_les", dest="mesh_les", type=int,
                   default=defaults.mesh_les,
                   help="Ranks of the LES instance axis: each of the N "
                        "processes (torchrun, or SPTPU_DIST_*) holds its "
                        "block of the instances")
    # reference process-topology flags (spmaster.py:101-148, 205-213),
    # accepted for drop-in compatibility
    p.add_argument("--lesprocs", dest="les_num_procs", metavar="N", type=int,
                   default=defaults.les_num_procs,
                   help="Devices per LES instance (reference: MPI tasks per "
                        "DALES): each plane splits into n_x x n_y blocks")
    p.add_argument("--gcmprocs", dest="gcm_num_procs", metavar="N", type=int,
                   default=defaults.gcm_num_procs,
                   help="Devices for the GCM (reference: OpenIFS MPI tasks); "
                        "N > 1 splits the GCM's grid into latitude bands "
                        "over every rank of the mesh (--mesh_les/--lesprocs); "
                        "no effect without a mesh")
    p.add_argument("--queue", dest="les_queue_threads", metavar="N", type=int,
                   default=defaults.les_queue_threads,
                   help="Ignored (reference worker-thread queue; the LES "
                        "fleet is one batched device computation here)")
    p.add_argument("--channel", dest="channel_type", metavar="TYPE",
                   choices=["sockets", "mpi", "nospawn", "spmd"],
                   default=defaults.channel_type,
                   help="Ignored (reference AMUSE channel; there is no RPC "
                        "in a single SPMD program)")
    p.add_argument("--profile", dest="jax_profile", action="store_true",
                   default=False,
                   help="Capture a torch.profiler trace of one coupled "
                        "step into ODIR/torch_trace.json")
    p.add_argument("--device", dest="device", metavar="DEV", default=None,
                   help="torch device of the run (default: the CUDA card; "
                        "'cpu' runs on the CPU)")
    return p


def geometries_from_args(args):
    geoms = []
    for pt in geometry.parse_lat_lons(args.points):
        geoms.append(geometry.Point(pt))
    poly_pts = geometry.parse_lat_lons(args.poly)
    if poly_pts:
        geoms.append(geometry.Polygon(poly_pts))
    if args.all:
        geoms = [geometry.Box(-float("inf"), -float("inf"),
                              float("inf"), float("inf"))]
    if args.polyfile:
        geoms.append(geometry.read_poly_file(args.polyfile))
    out_geoms = []
    out_pts = geometry.parse_lat_lons(args.output_poly)
    if out_pts:
        out_geoms.append(geometry.Polygon(out_pts))
    if args.output_polyfile:
        out_geoms.append(geometry.read_poly_file(args.output_polyfile))
    return geoms, out_geoms


def build_runner(argv=None, writer=None):
    """Parse argv and build the run's SPRunner (not initialized).
    writer: the spifs.nc writer class (default spifs.SpifsWriter)."""
    defaults = SPConfig()
    parser = build_parser(defaults)
    args = parser.parse_args(argv)
    # precedence: dataclass defaults < native input decks (namoptions /
    # fort.4, like the reference's Fortran codes configure themselves,
    # modfac.py:40-93) < --conf JSON < explicitly-given CLI flags
    cfg = defaults.replace(**{
        k: v for k, v in vars(args).items()
        if k in ("les_input_dir", "gcm_input_dir", "les_exp_name")})
    cfg = decks.apply_decks(cfg)
    if args.conf:
        cfg = read_config(args.conf, base=cfg)
    overrides = {k: v for k, v in vars(args).items()
                 if k in SPConfig.__dataclass_fields__
                 and v != parser.get_default(k)}
    cfg = cfg.replace(**overrides)
    geoms, out_geoms = geometries_from_args(args)
    return SPRunner(cfg, geoms, out_geoms, device=args.device, writer=writer,
                    restart_overlap=args.restart_overlap)


def drive(runner):
    """Initialize, run and finalize as the reference driver does; returns
    the exit code. The last log line is SUMMARY and the run's summary
    (``SPRunner.summary``) as JSON."""
    cfg = runner.cfg
    runner.initialize()
    if cfg.dryrun:
        log.info("dry run complete; gridpoints.txt written")
        return 0
    # one extra step: restart runs have a one-step overlap (spmaster.py:267)
    try:
        runner.run(cfg.gcm_steps + 1)
    except Exception:
        # the reference logs, finalizes (best-effort restart save +
        # netCDF close) and exits nonzero on a step failure
        # (splib.py:300-304)
        log.exception("Exception in coupled run; finalizing")
        runner.finalize(save_restart=True)
        return 1
    runner.finalize()
    log.info("%s%s", SUMMARY, json.dumps(runner.summary()))
    return 0


def main(argv=None):
    try:
        return drive(build_runner(argv))
    finally:
        pmesh.shutdown()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    print("-- spmaster (sp_coupler_tpu_torch) starting --")
    sys.exit(main())
