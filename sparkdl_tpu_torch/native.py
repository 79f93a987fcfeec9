"""ctypes binding for the native batch packer (native/packing.cpp).

The port's copy of ``sparkdl_tpu/native.py``: it binds the same
``native/libsparkdl_native.so``, built by ``native/Makefile``:
multithreaded resize + channel-reorder + uint8→f32 NHWC packing,
producing the host batch the scoring runner copies to the card.

``pack_images``/``pack_batch`` transparently fall back to numpy/PIL when the
shared library hasn't been built (``ensure_built`` compiles it with g++ on
first use; pybind11 is unavailable in this image, hence the C ABI).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Sequence

import numpy as np

_log = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libsparkdl_native.so")

_lock = threading.RLock()  # reentrant: _load holds it while calling ensure_built
_lib = None
_build_failed = False


def ensure_built() -> bool:
    """Compile the .so if missing/stale. Returns availability.

    Thread-safe: the build runs under ``_lock`` so concurrent first-use from
    multiple threads cannot race two ``make`` processes, and success is only
    reported after re-checking that the .so actually exists (make exiting 0
    with no artifact — e.g. a stale Makefile target — must not be trusted)."""
    global _build_failed
    src = os.path.join(_NATIVE_DIR, "packing.cpp")
    if not os.path.exists(src):
        return os.path.exists(_SO_PATH)

    def fresh() -> bool:
        return (os.path.exists(_SO_PATH)
                and os.path.getmtime(_SO_PATH) >= os.path.getmtime(src))

    if fresh():
        return True
    with _lock:
        if fresh():          # another thread built it while we waited
            return True
        if _build_failed:
            return False
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
            if not fresh():
                raise OSError("make succeeded but produced no "
                              f"{os.path.basename(_SO_PATH)}")
            return True
        except (subprocess.SubprocessError, OSError) as e:
            _build_failed = True
            # Loud once: the PIL fallback resizes through uint8, so resized
            # batches differ (<1 level per value) from native-built hosts.
            _log.warning(
                "sparkdl_tpu_torch native packer build failed (%s); using the "
                "pure-python fallback — resized image batches will differ "
                "slightly from native-enabled hosts", e)
            return False


_lib_failed = False  # loaded but unusable (ABI mismatch) — don't re-dlopen


def _load():
    global _lib, _lib_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _lib_failed:
            return None
        if not ensure_built():
            return None
        lib = ctypes.CDLL(_SO_PATH)
        lib.sdl_abi_version.restype = ctypes.c_int
        if lib.sdl_abi_version() != 2:
            # Cache the mismatch: without this every pack call would redo
            # dlopen+probe on the hot path, silently, forever.
            _lib_failed = True
            _log.warning(
                "libsparkdl_native.so has ABI %d (want 2) — prebuilt "
                "library is stale; using the pure-python fallback",
                lib.sdl_abi_version())
            return None
        _common = [
            ctypes.POINTER(ctypes.c_void_p),           # srcs
            ctypes.POINTER(ctypes.c_int32),            # heights
            ctypes.POINTER(ctypes.c_int32),            # widths
            ctypes.c_int32, ctypes.c_int32,            # n, c
        ]
        _tail = [
            ctypes.c_int32, ctypes.c_int32,            # out_h, out_w
            ctypes.c_int32,                            # flip_bgr
            ctypes.c_float, ctypes.c_float,            # scale, offset
            ctypes.c_int32,                            # n_threads
        ]
        lib.sdl_pack_images.restype = ctypes.c_int
        lib.sdl_pack_images.argtypes = (
            _common + [ctypes.POINTER(ctypes.c_float)] + _tail)
        lib.sdl_pack_images_u8.restype = ctypes.c_int
        lib.sdl_pack_images_u8.argtypes = (
            _common + [ctypes.POINTER(ctypes.c_uint8)] + _tail)
        lib.sdl_pack_batch.restype = ctypes.c_int
        lib.sdl_pack_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_float, ctypes.c_float, ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def pack_images(buffers: Sequence, heights: Sequence[int],
                widths: Sequence[int], channels: int, out_h: int, out_w: int,
                flip_bgr: bool = True, scale: float = 1.0,
                offset: float = 0.0, n_threads: int = 0,
                dtype=np.float32) -> np.ndarray:
    """Variable-size uint8 HWC image buffers → (N, out_h, out_w, C) batch.

    ``buffers``: per-image bytes-like objects (Arrow binary buffers, bytes,
    or uint8 arrays) each holding heights[i]*widths[i]*channels bytes.

    ``dtype``: float32 (default) or uint8. The uint8 output keeps the batch
    at 1 byte/sample so the host→device copy moves 4x fewer bytes; the
    device step casts to float. Resize math still runs in float either
    way.
    """
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.float32), np.dtype(np.uint8)):
        raise TypeError(f"pack_images output dtype must be float32 or "
                        f"uint8, got {dtype}")
    n = len(buffers)
    out = np.empty((n, out_h, out_w, channels), dtype=dtype)
    if n == 0:
        return out
    for b in buffers:
        if isinstance(b, np.ndarray) and b.dtype != np.uint8:
            raise TypeError(
                f"pack_images takes raw uint8 buffers, got ndarray dtype "
                f"{b.dtype} (value-casting would silently truncate)")
    lib = _load()
    if lib is None:
        return _pack_images_numpy(buffers, heights, widths, channels, out,
                                  flip_bgr, scale, offset)
    arrays = [np.frombuffer(b, dtype=np.uint8) if not isinstance(b, np.ndarray)
              else np.ascontiguousarray(b).reshape(-1)
              for b in buffers]
    for i, a in enumerate(arrays):
        if a.size != heights[i] * widths[i] * channels:
            raise ValueError(
                f"Image {i}: buffer has {a.size} bytes, expected "
                f"{heights[i]}x{widths[i]}x{channels}")
    ptrs = np.fromiter((a.ctypes.data for a in arrays), dtype=np.uint64,
                       count=n)
    # `arrays` stays alive past the native call — the addresses in `ptrs`
    # borrow its buffers
    result = _dispatch_pack(lib, ptrs, heights, widths, channels, out,
                            out_h, out_w, flip_bgr, scale, offset,
                            n_threads)
    del arrays
    return result


def pack_images_ptrs(ptrs: np.ndarray, heights: Sequence[int],
                     widths: Sequence[int], channels: int, out_h: int,
                     out_w: int, flip_bgr: bool = True, scale: float = 1.0,
                     offset: float = 0.0, n_threads: int = 0,
                     dtype=np.float32):
    """Zero-copy twin of :func:`pack_images`: ``ptrs`` is a uint64 array
    of source ADDRESSES (e.g. an Arrow binary values-buffer base +
    offsets), passed to C as the ``const uint8_t**`` directly — no
    per-row buffer objects or ctypes casts on the hot path. The caller
    owns both the address validity and the per-row size check (the
    addresses carry no length). Returns None when the native library is
    unavailable (the caller holds the real buffers and picks its own
    fallback)."""
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.float32), np.dtype(np.uint8)):
        raise TypeError(f"pack_images_ptrs output dtype must be float32 "
                        f"or uint8, got {dtype}")
    lib = _load()
    if lib is None:
        return None
    out = np.empty((len(ptrs), out_h, out_w, channels), dtype=dtype)
    return _dispatch_pack(lib, ptrs, heights, widths, channels, out,
                          out_h, out_w, flip_bgr, scale, offset, n_threads)


def _dispatch_pack(lib, ptrs, heights, widths, channels, out, out_h, out_w,
                   flip_bgr, scale, offset, n_threads) -> np.ndarray:
    """One marshalling point for the sdl_pack_images* C ABI — both the
    buffer-list and address-array entries go through here, so ABI changes
    can't drift between them. ``out.dtype`` selects the u8/f32 entry."""
    n = len(ptrs)
    if n == 0:
        return out
    ptrs = np.ascontiguousarray(ptrs, dtype=np.uint64)
    hs = np.ascontiguousarray(heights, dtype=np.int32)
    ws = np.ascontiguousarray(widths, dtype=np.int32)
    if out.dtype == np.uint8:
        entry, ctype = lib.sdl_pack_images_u8, ctypes.c_uint8
    else:
        entry, ctype = lib.sdl_pack_images, ctypes.c_float
    rc = entry(
        ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
        hs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ws.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, channels, out.ctypes.data_as(ctypes.POINTER(ctype)),
        out_h, out_w, int(flip_bgr), float(scale), float(offset), n_threads)
    if rc != 0:
        raise ValueError(f"sdl_pack_images failed with code {rc}")
    return out


def pack_batch(batch: np.ndarray, out_h: int | None = None,
               out_w: int | None = None, flip_bgr: bool = False,
               scale: float = 1.0, offset: float = 0.0,
               n_threads: int = 0) -> np.ndarray:
    """(N, H, W, C) uint8 → (N, out_h, out_w, C) float32 in one native call."""
    batch = np.ascontiguousarray(batch, dtype=np.uint8)
    n, h, w, c = batch.shape
    oh, ow = out_h or h, out_w or w
    lib = _load()
    if lib is None:
        bufs = [batch[i] for i in range(n)]
        out = np.empty((n, oh, ow, c), dtype=np.float32)
        return _pack_images_numpy(bufs, [h] * n, [w] * n, c, out, flip_bgr,
                                  scale, offset)
    out = np.empty((n, oh, ow, c), dtype=np.float32)
    rc = lib.sdl_pack_batch(
        batch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), oh, ow,
        int(flip_bgr), float(scale), float(offset), n_threads)
    if rc != 0:
        raise ValueError(f"sdl_pack_batch failed with code {rc}")
    return out


def _pack_images_numpy(buffers, heights, widths, channels, out, flip_bgr,
                       scale, offset) -> np.ndarray:
    """Pure-python fallback; PIL handles the resizes."""
    from PIL import Image
    n, oh, ow, c = out.shape
    for i in range(n):
        arr = np.frombuffer(buffers[i], dtype=np.uint8).reshape(
            heights[i], widths[i], channels)
        if flip_bgr and c >= 3:
            arr = np.concatenate([arr[..., 2::-1][..., :3], arr[..., 3:]],
                                 axis=-1)
        if (heights[i], widths[i]) != (oh, ow):
            img = Image.fromarray(arr.squeeze() if c == 1 else arr)
            arr = np.asarray(img.resize((ow, oh), Image.BILINEAR),
                             dtype=np.uint8)
            if arr.ndim == 2:
                arr = arr[:, :, None]
        vals = arr.astype(np.float32) * scale + offset
        if out.dtype == np.uint8:
            vals = np.clip(np.round(vals), 0, 255)
        out[i] = vals
    return out
