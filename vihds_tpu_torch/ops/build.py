"""Build and load the port's CUDA kernels.

Each source under ``vihds_tpu_torch/csrc`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``.  A library is built at first use, keyed by a hash of its source,
the headers under ``csrc`` and the flags, into ``build/kernels/`` beside the
package (a directory git ignores), so a fresh checkout builds its kernels by
itself.  Nothing here runs at import: the CPU tests import every module on a
machine with no ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "kernels",
)
#: kernel library name -> source file under csrc/: each fused kind's forward
#: and backward (ops/fused_ode.KINDS) and the black-box ODE's
#: (ops/fused_blackbox.py)
SOURCES = {
    "%s_%s" % (kind, d): "%s_%s.cu" % (kind, d)
    for kind in ("dr", "dr_prec", "relay", "relay_prec", "degrader", "degrader_prec", "blackbox")
    for d in ("fwd", "bwd")
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_loaded = {}


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def library_path(name):
    """Where library ``name`` is built: keyed by its source, every header
    under ``csrc`` (an edit to a shared header rebuilds every library) and
    the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for fname in [SOURCES[name]] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, "lib%s_%s.so" % (name, h.hexdigest()[:16]))


def build(names=None):
    """Compile every missing library of ``names`` (default: all), one
    ``nvcc`` per source, all started together.  Returns {name: ptxas log}
    for the libraries built now; raises RuntimeError naming the failures."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            continue
        tmp = "%s.%d.tmp" % (path, os.getpid())
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    logs, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s" % (name, proc.returncode, out))
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name):
    """The loaded ctypes library of kernel ``name``, built if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib
