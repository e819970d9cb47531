"""Build and bind the port's CUDA kernels.

Each kernel family is one source in ``csrc/`` with a plain C interface,
compiled by plain ``nvcc`` for ``sm_90a`` into a shared object per
(source, body-slot count N, dimension d, build variant) and loaded with
``ctypes``.  A build variant turns on compile-time branches of a source
(``VARIANT_FLAGS``; "" is the default build, which holds none of them),
so a branch that a path does not take adds nothing to its build.
Builds land in the git-ignored ``_build/`` directory at first use (never
at import), keyed by a hash of the source, the shared headers and the
flags, so an edited source is rebuilt and an unchanged one is not.
``build`` starts every requested ``nvcc`` at once, so the kernel families
and slot counts compile in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
#: no multiply-add contraction: a kernel then rounds as its plain version
#: does, and deep-n_sub systems (whose spring momentum amplifies a
#: half-ulp per trip) stay within the comparison tolerances
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


#: the parts of a build variant name ("_"-joined) and the macro each sets
#: to 1: the reflection fold of the analysis and MEGNO kernels, the
#: "reference" eps* gradient's fallback, and the multi-step kernel's
#: one-thread layout at every N
VARIANT_FLAGS = {"refl": "HS_REFL", "ref": "HS_REF", "thread": "HS_THREAD"}


def _defines(variant: str):
    return [f"-D{VARIANT_FLAGS[part]}=1" for part in variant.split("_")
            if part]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def source_path(name: str) -> str:
    return os.path.join(CSRC, name)


def lib_path(source: str, n: int, d: int, variant: str = "") -> str:
    """Where the library of ``source`` (a file name in ``csrc/``) for
    (n, d) in build ``variant`` is built."""
    _defines(variant)  # an unknown variant raises here
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for path in [source_path(source)] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as fh:
            h.update(fh.read())
    stem = os.path.splitext(source)[0]
    var = f"_{variant}" if variant else ""
    return os.path.join(BUILD_DIR,
                        f"lib{stem}_n{n}_d{d}{var}_{h.hexdigest()[:12]}.so")


def _read(path: str) -> str:
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


def job_name(job) -> str:
    """A job's name in reports: "source N=n d=d [variant]"."""
    source, n, d, *var = job
    return f"{source} N={n} d={d}" + (f" {var[0]}" if var and var[0] else "")


def build(jobs) -> dict:
    """Build each job of ``jobs``, (source, n, d) or (source, n, d,
    variant), one ``nvcc`` per job, all started together.  Returns
    {job: (path, seconds, ptxas report)}; a job already built from the
    same sources is not rebuilt (0 seconds, the report kept from its
    build).  Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, out = {}, {}
    for job in jobs:
        source, n, d, *var = job
        variant = var[0] if var else ""
        path = lib_path(source, n, d, variant)
        if os.path.exists(path):
            out[job] = (path, 0.0, _read(f"{path}.ptxas"))
            continue
        tmp = f"{path}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, f"-DHS_N={n}", f"-DHS_D={d}",
               *_defines(variant), "-o", tmp, source_path(source)]
        procs[job] = (path, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for job, (path, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc for {job} failed:\n{log}")
            continue
        report = "\n".join(ln for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln
                           or "Compiling entry" in ln)
        with open(f"{path}.ptxas", "w") as fh:
            fh.write(report)
        os.replace(tmp, path)
        out[job] = (path, time.perf_counter() - t0, report)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(source: str, n: int, d: int, variant: str = ""):
    """The ``ctypes`` library of ``source`` for (n, d) in build
    ``variant``, built on first use; ``hs_error_string`` is bound, the
    caller binds its entry."""
    job = (source, n, d, variant)
    lib = ctypes.CDLL(build([job])[job][0])
    lib.hs_error_string.argtypes = [ctypes.c_int]
    lib.hs_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib, code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.hs_error_string(code).decode()}")


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def pointers(*buffers):
    """data_ptr of each buffer handed to a kernel (all contiguous)."""
    for t in buffers:
        if not t.is_contiguous():
            raise ValueError("kernel buffers must be contiguous")
    return [t.data_ptr() for t in buffers]
