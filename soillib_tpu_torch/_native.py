"""Build and load the package's CUDA kernels (csrc/*.cu) with nvcc.

Each source is compiled into a shared library with a plain C interface
under `_build/` (listed in .gitignore) and loaded with ctypes. The first
use of any kernel builds every source that has no library yet, one nvcc
process each, all started together. The library's file name carries a
hash of the source and the flags, so an edited source is rebuilt rather
than a stale library reused. Nothing is built or loaded when the module
is imported.
"""

from __future__ import annotations

import ctypes
import glob
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


def sources() -> list:
    """Names of the kernel sources, csrc/<name>.cu."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


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


def build() -> dict:
    """Compile every csrc/*.cu into a shared library, one nvcc process per
    source, all at once; returns {name: library path}. Libraries already
    built from the same source and flags are kept. Each compiler's output
    (registers and shared memory) is written next to its library as
    `.log`. Raises, naming every source that failed, after all have
    finished."""
    os.makedirs(BUILD, exist_ok=True)
    paths = {name: _target(name) for name in sources()}
    running = {}
    try:
        for name, path in paths.items():
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(f"{path}.log", "w") as log:
                proc = subprocess.Popen(
                    [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                     os.path.join(CSRC, f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT)
            running[name] = (proc, tmp, path)
        failed = []
        for name, (proc, tmp, path) in running.items():
            rc = proc.wait()
            if rc != 0:
                failed.append(f"{name} (nvcc exit {rc}, see {path}.log)")
            else:
                os.replace(tmp, path)
    finally:
        for proc, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("kernel build failed: " + "; ".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The shared library built from csrc/<name>.cu, loaded once per
    process. If it is not built yet, every source without a library is
    built first, in parallel."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _target(name)
            if not os.path.exists(path):
                build()
            lib = _libs[name] = ctypes.CDLL(path)
        return lib


def build_log(name: str) -> str:
    """The compiler's output for csrc/<name>.cu, or '' if none was kept."""
    path = _target(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
