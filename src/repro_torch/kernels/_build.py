"""Build the port's CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` into ``build/<name>-<hash>.so`` at the repository root. The
hash covers the source and the flags, so an edited kernel rebuilds and an
unchanged one loads the library already there. Sources build in parallel
(one ``nvcc`` each, all started together). ``nvcc``'s own output —
``-Xptxas -v`` register and shared-memory counts included — is kept
beside the library as ``<name>-<hash>.log``.

Nothing here runs at import: the CPU tests import every module of the
port, and this machine-independent code only calls ``nvcc`` when a kernel
is first launched on a CUDA tensor (or when a caller builds explicitly).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME``, /usr/local/cuda, PATH)."""
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source on the machine with the card")
    return found


def target(name: str) -> Path:
    """The library path of kernel source ``csrc/<name>.cu``."""
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: list[str]) -> dict[str, float]:
    """Compile every source not built yet, all in parallel; returns the
    seconds each compile took (0.0 for a library already built). Raises
    ``RuntimeError`` with the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: target(n) for n in names if not target(n).exists()}
    out = {n: 0.0 for n in names}
    procs = {}
    t0 = time.perf_counter()
    for name, lib in todo.items():
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        lib.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            continue
        os.replace(tmp, lib)        # atomic: a reader never sees half a .so
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process."""
    build([name])
    return ctypes.CDLL(str(target(name)))
