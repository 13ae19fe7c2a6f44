"""Build and load the hand-written Hopper kernels of ``csrc/``.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.
Builds happen at first use, one ``nvcc`` per source, all started
together, into ``_build/<digest>/`` beside this file, where the digest
covers the sources and the flags: an edited source gets a fresh
directory, an unchanged one is loaded as it is.  Nothing here runs when
the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_ROOT = Path(__file__).parent / "_build"
# library name -> source file
SOURCES = {"linear_wf": "linear_wf.cu", "affine_wf": "affine_wf.cu",
           "traceback": "traceback.cu", "minimizer": "minimizer.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_wgmma": "flash_attention_wgmma.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_int64
# C entry point -> (library, argtypes); every entry returns a cudaError_t
ENTRIES = {
    "linear_wf_launch": ("linear_wf", [_P, _P, _P] + [_I] * 3 + [_P]),
    "affine_wf_dist_launch": ("affine_wf", [_P, _P, _P] + [_I] * 4 + [_P]),
    "affine_wf_launch": ("affine_wf", [_P] * 4 + [_I] * 5 + [_P]),
    "affine_traceback_launch": ("traceback",
                                [_P] * 5 + [_I] * 7 + [_P]),
    "minimizer_launch": ("minimizer", [_P] * 3 + [_I] * 8 + [_P]),
    "flash_attention_launch": ("flash_attention",
                               [_P] * 4 + [_I] * 6 + [_F] + [_L] * 9 + [_P]),
    "flash_attention_wgmma_launch": ("flash_attention_wgmma",
                                     [_P] * 4 + [_I] * 6 + [_F] + [_L] * 9
                                     + [_P]),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` failed to compile a kernel library (its output attached).
    The resilience layer never retries around it: a kernel that does not
    build is a fault to report, not one to degrade past."""


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> dict[str, dict]:
    """Compile every library that is not built yet, in parallel.

    Returns ``{name: {"path", "seconds", "log"}}`` for every library;
    ``log`` holds nvcc's ``-Xptxas -v`` report (registers, shared memory,
    spills) for the libraries compiled by this call, and ``seconds`` is 0
    for those found already built.  Raises ``KernelBuildError`` with
    nvcc's output when a compile fails.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    info = {}
    for name, src in SOURCES.items():
        lib = out_dir / f"lib{name}.so"
        info[name] = dict(path=str(lib), seconds=0.0, log="")
        if lib.exists():
            continue
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, lib)
    failed = []
    for name, (proc, t0, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        info[name].update(seconds=time.perf_counter() - t0, log=log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: concurrent builders never see half
    if failed:
        raise KernelBuildError("\n".join(failed))
    return info


def entry(fn: str):
    """The ctypes function ``fn`` of its library, building on first use."""
    name, argtypes = ENTRIES[fn]
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build()[name]["path"]
            lib = _loaded[name] = ctypes.CDLL(path)
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f
