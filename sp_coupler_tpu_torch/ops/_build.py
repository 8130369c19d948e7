"""Build the package's CUDA sources at first use, and bind them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (sm_90a) into
a shared library with a plain C interface, loaded with ctypes. The result
lives in ``sp_coupler_tpu_torch/_build/<name>-<hash>.so`` (git-ignored),
keyed by a hash of the source, the shared headers ``csrc/*.cuh`` and the
compile command, so a fresh checkout builds everything on its first call
and later calls reuse it. A failed build raises with the compiler's
output. ``function``, ``check_cuda`` and ``launch`` serve the kernel
wrappers.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

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


def source_key(name):
    """Hash of csrc/<name>.cu, every shared header csrc/*.cuh and the
    compile command: a change to any of them makes a new build."""
    h = hashlib.sha256(" ".join(nvcc_command("src", "out")).encode())
    src = os.path.join(CSRC_DIR, name + ".cu")
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(name):
    """Compile csrc/<name>.cu (if not built yet); return the .so path and
    the compiler's log ('' when the library was already built)."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    out = os.path.join(BUILD_DIR, "%s-%s.so" % (name, source_key(name)))
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


def function(name, fn, argtypes):
    """The C function ``fn`` of csrc/<name>.cu, returning an int (its CUDA
    error code); pass pointers and the stream as ctypes.c_void_p."""
    f = getattr(load(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check_cuda(x, shape, name):
    """x's data pointer, after checking that x is a contiguous float32 CUDA
    tensor of the given shape (ValueError otherwise)."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError("%s: need a float32 CUDA tensor, got %s %s"
                         % (name, x.dtype, x.device))
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError("%s: need a contiguous %s tensor, got %s"
                         % (name, tuple(shape), tuple(x.shape)))
    return x.data_ptr()


def launch(fn, args, device, what):
    """Call the C entry ``fn(*args, stream)`` with device's card current and
    its current stream, so that a rank on cuda:1 launches on cuda:1 (the
    entries keep their shared-memory allowance per card, by
    cudaGetDevice). Raises if the entry returned a CUDA error code other
    than 0."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (what, err))
