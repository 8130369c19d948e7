"""Build the package's CUDA sources at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (sm_90a) into
a shared library with a plain C interface, loaded with ctypes. The result
lives in ``sp_coupler_tpu_torch/_build/<name>-<hash>.so`` (git-ignored),
keyed by a hash of the source and the compile command, so a fresh
checkout builds everything on its first call and later calls reuse it.
A failed build raises with the compiler's output.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

_loaded = {}


def find_nvcc():
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "sp_coupler_tpu_torch need the CUDA toolkit")
    return nvcc


def nvcc_command(src, out, nvcc="nvcc"):
    """The compile command: Hopper sm_90a, -O3, no fast math (the exp,
    log and pow accuracy decides the kernels' tolerances)."""
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", out, src]


def build(name):
    """Compile csrc/<name>.cu (if not built yet); return the .so path and
    the compiler's log ('' when the library was already built)."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        text = f.read()
    key = hashlib.sha256(text + " ".join(
        nvcc_command("src", "out")).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, "%s-%s.so" % (name, key))
    if os.path.isfile(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = nvcc_command(src, tmp, find_nvcc())
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed (%d) for %s:\n%s\n%s" % (
            res.returncode, src, res.stdout, res.stderr))
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def load(name):
    """ctypes handle of the built library csrc/<name>.cu (built on first
    use in this process)."""
    if name not in _loaded:
        path, log = build(name)
        _loaded[name] = (ctypes.CDLL(path), log)
    return _loaded[name][0]


def build_log(name):
    """The compiler's output of this process's build of <name> ('' if the
    library was already on disk)."""
    return _loaded.get(name, (None, ""))[1]
