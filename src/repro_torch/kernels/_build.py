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

Kernels launch from several threads at once (the checkpoint's encode and
restore workers), so building, loading and counting launches are each
safe to call from any thread: one process-wide lock serialises builds and
loads, every compile writes its own temporary file, and
:func:`count_launch` bumps a wrapper's ``launches`` under a lock.

A wrapper counts on the host, once per call, so a kernel captured in a
CUDA graph is counted once at its capture and not at all when the graph
replays. :func:`held_launches` takes the counts of a warm-up and a
capture off again, and :func:`replay` adds the capture's back once for
every replay: the counts then say how often each kernel ran. A block
holds the launches of its own thread and, given a CUDA stream, those of
any thread on that stream: autograd runs a CUDA backward on a thread of
its own, on the stream of the forward.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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


#: serialises builds, loads and other once-per-process set-up of the kernels
lock = threading.RLock()
_libs: dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()
_held = threading.local()          # .ticks: the open held_launches dict
_held_streams: dict = {}           # CUDA stream handle -> its open dict


def build(names: list[str]) -> dict[str, float]:
    """Compile every source not built yet, all in parallel; returns the
    seconds each compile took (0.0 for a library already built). Raises
    ``RuntimeError`` with the compiler's output when one fails. Callers
    on other threads wait for a build in progress and then find it done."""
    with lock:
        return _compile(names)


def _compile(names: list[str]) -> dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: target(n) for n in names if not target(n).exists()}
    out = {n: 0.0 for n in names}
    procs = {}
    t0 = time.perf_counter()
    for name, lib in todo.items():
        # unique per process and thread: another process may build into
        # the same directory
        tmp = lib.with_suffix(f".tmp{os.getpid()}-{threading.get_ident()}")
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


def load(name: str, signatures: dict[str, tuple[list, type]]
         ) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process,
    with ``signatures`` (entry name -> (argtypes, restype)) set on its
    entries before any caller sees it."""
    with lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(target(name)))
            for entry, (args, res) in signatures.items():
                fn = getattr(lib, entry)
                fn.argtypes = args
                fn.restype = res
            _libs[name] = lib
        return lib


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's ``launches`` (called where the
    wrapper launches its kernel, and nowhere else)."""
    with _count_lock:
        wrapper.launches += 1
        ticks = getattr(_held, "ticks", None)
        if ticks is None and _held_streams:
            import torch

            ticks = _held_streams.get(torch.cuda.current_stream().cuda_stream)
        if ticks is not None:
            ticks[wrapper] = ticks.get(wrapper, 0) + 1


@contextlib.contextmanager
def held_launches(stream=None):
    """Hold back the launches counted on this thread inside the block,
    and with ``stream`` (a ``torch.cuda.Stream``) those counted on any
    thread while that stream is its current one.

    Yields a dict ``{wrapper: launches}`` that fills as wrappers count;
    at the end of the block those launches are taken off the wrappers'
    counts again. Other threads' launches count as always. A graph's
    warm-up runs inside one such block (its counts are dropped) and its
    capture inside another (whose dict :func:`replay` adds back once per
    replay). Blocks do not nest."""
    if getattr(_held, "ticks", None) is not None:
        raise RuntimeError("held_launches blocks do not nest")
    ticks: dict = {}
    _held.ticks = ticks
    key = stream.cuda_stream if stream is not None else None
    if key is not None:
        with _count_lock:
            _held_streams[key] = ticks
    try:
        yield ticks
    finally:
        _held.ticks = None
        with _count_lock:
            if key is not None:
                del _held_streams[key]
            for wrapper, n in ticks.items():
                wrapper.launches -= n


def replay(graph, ticks: dict) -> None:
    """Replay a captured graph (anything with ``replay()``) and add the
    launches its capture held back (:func:`held_launches`) once."""
    graph.replay()
    with _count_lock:
        for wrapper, n in ticks.items():
            wrapper.launches += n
