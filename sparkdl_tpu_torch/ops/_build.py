"""Builds the package's CUDA kernels at first use and loads them.

Every ``sparkdl_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc``
process, all started together, and the objects are linked into one
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu  # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o _build/libsparkdl_kernels_<hash>.so *.o

(``-Xptxas -v``: each kernel's registers, shared memory and spills land
in ``_build/libsparkdl_kernels_<hash>.log``.) The build takes as long as
its slowest source, not the sum of them.

No PyTorch header is compiled, so the build takes seconds. The library
lands in ``sparkdl_tpu_torch/_build/`` (listed in ``.gitignore``) under a
name keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the library already built. It is
loaded with ``ctypes``; each ``extern "C"`` launcher returns its
``cudaError_t`` and :func:`check` raises when that is not 0.

A missing ``nvcc`` or a failed build raises. Nothing falls back.
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

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong

# name → argtypes of every launcher in csrc/ (restype is always c_int,
# the launcher's cudaError_t).
SIGNATURES = {
    # q, k, v, kv_mask|NULL, o, lse, B, H, S, D, causal, variant,
    # tiles|NULL, stream
    "sdl_flash_attention_fwd": [P, P, P, P, P, P, I, I, I, I, I, I, P, P],
    # q, k, v, o, lse, do, kv_mask|NULL, dq, dk, dv, delta, B, H, S, D,
    # causal, variant, stream
    "sdl_flash_attention_bwd": [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I,
                                I, I, P],
    # q, k, v, o, cur|NULL, cur_scalar, pad|NULL, B, Hkv, rep, L, D,
    # is_bf16, rt, chunk, ws, ws_floats, counters, blocks|NULL, stream
    "sdl_flash_decode": [P, P, P, P, P, I, P, I, I, I, I, I, I, I, I, P, LL,
                         P, P, P],
    # q, k, v, scales|NULL, tables, cur, pad|NULL, o, B, Hkv, rep, S, D,
    # bs, MB, is_bf16, kv_kind, rt, chunk, ws, ws_floats, counters,
    # blocks|NULL, stream
    "sdl_paged_flash_decode": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                               I, I, I, I, P, LL, P, P, P],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels of sparkdl_tpu_torch are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    objs = out.with_suffix(f".{os.getpid()}.objs")
    objs.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    jobs = []
    try:
        for src in sorted(SRC_DIR.glob("*.cu")):
            obj, log = objs / f"{src.stem}.o", objs / f"{src.stem}.log"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            with open(log, "w") as f:  # a file, so no pipe can fill up
                jobs.append((src, obj, log, subprocess.Popen(
                    cmd, stdout=f, stderr=subprocess.STDOUT)))
        failed = [src.name for src, _, _, p in jobs if p.wait() != 0]
        logs = "".join(log.read_text() for _, _, log, _ in jobs)
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _, _ in jobs)]
        res = None if failed else subprocess.run(cmd, capture_output=True,
                                                 text=True)
        build_info.update(seconds=time.perf_counter() - t0, command=cmd,
                          log=logs + ("" if res is None
                                      else res.stdout + res.stderr))
        out.with_suffix(".log").write_text(build_info["log"])
        if failed or res.returncode != 0:
            tmp.unlink(missing_ok=True)
            what = (f"compiling {', '.join(failed)}" if failed
                    else f"linking ({res.returncode})")
            raise RuntimeError(f"nvcc failed {what}:\n"
                               f"{build_info['log'][-4000:]}")
        os.replace(tmp, out)  # atomic: a concurrent process sees all or none
    finally:
        for _, _, _, p in jobs:  # a raise above must leave no nvcc running
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(objs, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            BUILD_DIR.mkdir(exist_ok=True)
            so = BUILD_DIR / f"libsparkdl_kernels_{_digest()}.so"
            if so.exists():
                # built earlier: no nvcc ran, so no build time; the
                # ptxas report is the one written beside the library
                log = so.with_suffix(".log")
                build_info.update(cached=True, seconds=None,
                                  log=log.read_text() if log.exists()
                                  else None)
            else:
                _compile(so)
                build_info["cached"] = False
            lib = ctypes.CDLL(str(so))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.sdl_error_string.argtypes = [ctypes.c_int]
            lib.sdl_error_string.restype = ctypes.c_char_p
            build_info["library"] = str(so)
            _lib = lib
        return _lib


class CudaError(RuntimeError):
    """A launcher returned a non-zero ``cudaError_t``: the launch was
    refused, or an earlier kernel on the stream faulted."""


def check(err: int, what: str) -> None:
    """Raise :class:`CudaError` when a launcher returned a non-zero
    ``cudaError_t``."""
    if err != 0:
        name = library().sdl_error_string(err).decode()
        raise CudaError(f"{what}: CUDA error {err} ({name})")
