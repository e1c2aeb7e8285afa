"""Build and load the package's CUDA kernels (csrc/*.cu) with nvcc.

Each source is compiled on first use into a shared library with a plain C
interface under `_build/` (listed in .gitignore) and loaded with ctypes.
The library's file name carries a hash of the source and the flags, so an
edited source is rebuilt rather than a stale library reused. Nothing is
built or loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

# No --use_fast_math and no FMA contraction (-fmad=false): the kernels are
# held against the plain torch versions, which round every multiply and add
# on their own, at f32-roundoff tolerances that growth factors near the
# cohort rules' +-40 exponent clip amplify. `-Xptxas -v` reports registers,
# shared memory and spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    /usr/local/cuda/bin/nvcc. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + repr(NVCC_FLAGS).encode())
    return os.path.join(BUILD, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu into a shared library and return its path.
    A library already built from the same source and flags is kept. The
    compiler's output (register and shared-memory use) is written next to
    the library as `.log`."""
    os.makedirs(BUILD, exist_ok=True)
    path = _target(name)
    if os.path.exists(path):
        return path
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(f"{path}.log", "w") as log:
        rc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                             os.path.join(CSRC, f"{name}.cu")],
                            stdout=log, stderr=subprocess.STDOUT).returncode
    if rc != 0:
        raise RuntimeError(f"kernel build failed: {name} (nvcc exit {rc}, "
                           f"see {path}.log)")
    os.replace(tmp, path)
    return path


def load(name: str) -> ctypes.CDLL:
    """The shared library built from csrc/<name>.cu (building it first
    if needed), loaded once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib


def build_log(name: str) -> str:
    """The compiler's output for csrc/<name>.cu, or '' if none was kept."""
    path = _target(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
