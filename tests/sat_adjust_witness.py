"""tests/test_torch_les.py::test_sat_adjust[2] as the first computation of
fresh processes started side by side, the way a whole run of the test
suite on several workers starts them.

    JAX_PLATFORMS=cpu python tests/sat_adjust_witness.py [ROUNDS [PROCS]]
        [cold] [collect]

starts PROCS processes at once (default 6, the suite's usual workers),
ROUNDS times (default 20). Each process sets itself up as a test worker
does (tests/conftest.py's JAX settings, then tests/test_torch_les.py's
imports, which put torch on one thread), builds the test's inputs for
n_iter = 2 and runs JAX's sat_adjust and the port's in the test's order,
JAX first, twice: the process's first results, then its second. It prints
one JSON line: for each side and output (T, ql, qs) the points where its
first result differs from its second (0: the side gave the same bits
both times), and the points where the port lies outside the test's
tolerance of JAX (rtol 1e-5, atol 1e-6 max|ref|) in the first results and
in the second. The parent prints every line and then a summary: how many
processes failed the test's check on their first results, and in how
many each side moved between its first and second result. With "cold"
each round's processes share a new, empty persistent compilation cache
(SP_TEST_CACHE_DIR), as a test run on a fresh temporary directory has.
With "collect" each process first imports every tests/test_*.py module
in name order, as a test worker collects them all before its first test
(their import-time settings, such as torch's thread count, then hold).

    python tests/sat_adjust_witness.py one     (one process, its line)
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
NAMES = ("T", "ql", "qs")


def outside(got, ref, rtol=1e-5, atol_frac=1e-6):
    """Points of got outside test_torch_les.close's tolerance of ref."""
    import numpy as np
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    return int(np.sum(np.abs(got - ref) > atol_frac * scale
                      + rtol * np.abs(ref)))


def one(collect=False):
    import glob
    import importlib
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import conftest  # noqa: F401  (the test session's JAX settings)
    if collect:
        for f in sorted(glob.glob(os.path.join(HERE, "test_*.py"))):
            importlib.import_module(os.path.basename(f)[:-3])
    import test_torch_les as t
    import numpy as np
    rng = np.random.default_rng(2)
    thl = rng.uniform(280, 320, 4096).astype(np.float32)
    qt = rng.uniform(0.0, 0.025, 4096).astype(np.float32)
    p = rng.uniform(6e4, 1.02e5, 4096).astype(np.float32)

    def jax_side():
        return [np.asarray(x) for x in t.jthermo.sat_adjust(
            t.jnp.asarray(thl), t.jnp.asarray(qt), t.jnp.asarray(p),
            n_iter=2)]

    def port_side():
        return [x.numpy() for x in t.tthermo.sat_adjust(
            t.torch.tensor(thl), t.torch.tensor(qt), t.torch.tensor(p),
            n_iter=2)]

    j1 = jax_side()
    p1 = port_side()
    j2, p2 = jax_side(), port_side()
    line = dict(pid=os.getpid(), torch_threads=t.torch.get_num_threads())
    for side, a, b in (("jax", j1, j2), ("port", p1, p2)):
        line[side + "_moved"] = {n: int(np.sum(x != y))
                                 for n, x, y in zip(NAMES, a, b)}
    for k, (pt, jx) in (("first", (p1, j1)), ("second", (p2, j2))):
        line[k + "_outside"] = {n: outside(x, y)
                                for n, x, y in zip(NAMES, pt, jx)}
        line[k + "_ql_max_diff"] = float(np.max(np.abs(pt[1] - jx[1])))
    print(json.dumps(line), flush=True)


def main(rounds=20, procs=6, cold=False, collect=False):
    import shutil
    import tempfile
    lines = []
    t0 = time.time()
    for r in range(rounds):
        env = dict(os.environ)
        if cold:
            env["SP_TEST_CACHE_DIR"] = tempfile.mkdtemp(prefix="satcache")
        ps = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                "one"] + ["collect"] * collect,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.DEVNULL, text=True, env=env)
              for _ in range(procs)]
        for p in ps:
            out = p.communicate()[0].strip().splitlines()
            if p.returncode != 0 or not out:
                raise SystemExit("round %d: a process exited %d"
                                 % (r, p.returncode))
            print(out[-1], flush=True)
            lines.append(json.loads(out[-1]))
        if cold:
            shutil.rmtree(env["SP_TEST_CACHE_DIR"])
    count = lambda f: sum(1 for ln in lines if f(ln))
    print(json.dumps(dict(
        processes=len(lines), rounds=rounds, side_by_side=procs, cold=cold,
        collect=collect,
        seconds=time.time() - t0,
        first_fails=count(lambda ln: any(ln["first_outside"].values())),
        second_fails=count(lambda ln: any(ln["second_outside"].values())),
        jax_moved=count(lambda ln: any(ln["jax_moved"].values())),
        port_moved=count(lambda ln: any(ln["port_moved"].values())))))


if __name__ == "__main__":
    if sys.argv[1:2] == ["one"]:
        one("collect" in sys.argv)
    else:
        main(*[int(a) for a in sys.argv[1:3] if a.isdigit()],
             cold="cold" in sys.argv, collect="collect" in sys.argv)
