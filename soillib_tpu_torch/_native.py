"""Build and load the package's CUDA kernels (csrc/*.cu) with nvcc.

Each source is compiled into a shared library with a plain C interface
under `_build/` (listed in .gitignore) and loaded with ctypes. The first
use of any kernel builds every source that has no library yet, one nvcc
process each, all started together. A source may also be built with
-D defines into a library of its own (a variant: the cohort kernel's
closure variants), at its first use or several at once (`build_variants`).
The library's file name carries a hash of the source, the flags and the
defines, so an edited source is rebuilt rather than a stale library
reused. Each library is compiled to a temporary file and moved into place
(`os.replace`), so a process never loads a half-written one. Nothing is
built or loaded when the module is imported.
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


def _target(name: str, defines=()) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        data = f.read() + repr(NVCC_FLAGS).encode()
    if defines:
        data += repr(tuple(defines)).encode()
    digest = hashlib.sha256(data).hexdigest()[:16]
    return os.path.join(BUILD, f"lib{name}-{digest}.so")


def _compile(jobs) -> None:
    """Run one nvcc per (name, defines, library path) of `jobs`, all at
    once; each writes a temporary file that is moved into place when it
    succeeds, and its compiler output (registers, shared memory, spills)
    to `<path>.log`. Raises, naming every job that failed, after all have
    finished."""
    os.makedirs(BUILD, exist_ok=True)
    running = []
    failed = []
    try:
        for name, defines, path in jobs:
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(f"{path}.log", "w") as log:
                proc = subprocess.Popen(
                    [nvcc_path(), *NVCC_FLAGS, *defines, "-o", tmp,
                     os.path.join(CSRC, f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT)
            running.append((name, defines, proc, tmp, path))
        for name, defines, proc, tmp, path in running:
            rc = proc.wait()
            if rc != 0:
                what = f"{name} {' '.join(defines)}".strip()
                failed.append(f"{what} (nvcc exit {rc}, see {path}.log)")
            else:
                os.replace(tmp, path)
    finally:
        for _, _, proc, _, _ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("kernel build failed: " + "; ".join(failed))


def build() -> dict:
    """Compile every csrc/*.cu into a shared library, one nvcc process per
    source, all at once; returns {name: library path}. Libraries already
    built from the same source and flags are kept."""
    paths = {name: _target(name) for name in sources()}
    _compile([(name, (), path) for name, path in paths.items()
              if not os.path.exists(path)])
    return paths


def build_variants(name: str, variants) -> list:
    """Compile csrc/<name>.cu once per tuple of -D defines in `variants`,
    all at once; returns the library paths in that order. Libraries
    already built are kept."""
    paths = [_target(name, tuple(d)) for d in variants]
    todo = {}
    for d, path in zip(variants, paths):
        if not os.path.exists(path):
            todo[path] = (name, tuple(d), path)
    _compile(list(todo.values()))
    return paths


def load(name: str, defines=()) -> ctypes.CDLL:
    """The shared library built from csrc/<name>.cu (with the -D
    `defines`, if any), loaded once per process. If the plain library is
    not built yet, every source without a library is built first, in
    parallel; a variant is built alone."""
    defines = tuple(defines)
    with _lock:
        lib = _libs.get((name, defines))
        if lib is None:
            path = _target(name, defines)
            if not os.path.exists(path):
                if defines:
                    build_variants(name, [defines])
                else:
                    build()
            lib = _libs[(name, defines)] = ctypes.CDLL(path)
        return lib


def build_log(name: str, defines=()) -> str:
    """The compiler's output for csrc/<name>.cu (with the -D `defines`),
    or '' if none was kept."""
    path = _target(name, tuple(defines)) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
