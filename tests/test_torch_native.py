"""The port's copy of the native batch packer (``sparkdl_tpu_torch.native``,
the same ``native/libsparkdl_native.so``) held against the JAX package's
``sparkdl_tpu.native``: the twins of the fifteen tests of
``tests/test_native.py``. Each packs the same bytes through both modules
and requires the same array bitwise (one library, one numpy fallback),
beside the reference test's own checks; the resize twins keep the
reference's closeness to ``jax.image.resize`` (1e-3 on 0–255)."""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import threading

import jax
import numpy as np
import pytest

from sparkdl_tpu import native as jnative
from sparkdl_tpu_torch import native


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.ensure_built():
        pytest.skip("native toolchain unavailable")


def _pack(*args, **kw):
    """``pack_batch`` through the port, held bitwise to the reference."""
    out = native.pack_batch(*args, **kw)
    np.testing.assert_array_equal(out, jnative.pack_batch(*args, **kw))
    return out


def _pack_images(*args, **kw):
    out = native.pack_images(*args, **kw)
    np.testing.assert_array_equal(out, jnative.pack_images(*args, **kw))
    return out


def test_abi_available():
    assert native.available() and jnative.available()
    assert native._SO_PATH == jnative._SO_PATH


def test_pack_batch_exact_no_resize():
    rng = np.random.RandomState(0)
    b = rng.randint(0, 256, (4, 5, 6, 3)).astype(np.uint8)
    out = _pack(b, flip_bgr=True, scale=1 / 127.5, offset=-1.0)
    assert out.dtype == np.float32
    want = b[..., ::-1].astype(np.float32) / 127.5 - 1.0
    assert np.allclose(out, want, atol=1e-6)


def test_pack_batch_matches_jax_resize():
    rng = np.random.RandomState(1)
    for (h, w), (oh, ow) in [((10, 12), (8, 8)), ((7, 5), (16, 16)),
                             ((20, 20), (8, 14))]:
        src = rng.randint(0, 256, (2, h, w, 3)).astype(np.uint8)
        nat = _pack(src, oh, ow)
        ref = np.asarray(jax.image.resize(
            src.astype(np.float32), (2, oh, ow, 3), method="bilinear"))
        assert np.abs(nat - ref).max() < 1e-3, ((h, w), (oh, ow))


def test_pack_images_variable_sizes():
    rng = np.random.RandomState(2)
    hs, ws = [9, 17, 8], [11, 6, 8]
    bufs = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8).tobytes()
            for h, w in zip(hs, ws)]
    out = _pack_images(bufs, hs, ws, 3, 8, 8, flip_bgr=True)
    assert out.shape == (3, 8, 8, 3)
    for i, (h, w) in enumerate(zip(hs, ws)):
        src = np.frombuffer(bufs[i], np.uint8).reshape(h, w, 3)
        ref = np.asarray(jax.image.resize(
            src[..., ::-1].astype(np.float32), (8, 8, 3), method="bilinear"))
        assert np.abs(out[i] - ref).max() < 1e-3


def test_bgra_flip_native_and_python_paths_agree():
    """c=4 flip is BGRA→RGBA (alpha kept) on every path, in both
    packages' ``imageIO``."""
    from sparkdl_tpu.image import imageIO as jio
    from sparkdl_tpu_torch.image import imageIO

    rng = np.random.RandomState(9)
    arr = rng.randint(0, 256, (5, 5, 4)).astype(np.uint8)
    structs = [imageIO.imageArrayToStruct(arr)]
    assert structs == [jio.imageArrayToStruct(arr)]
    nat = imageIO.structsToNHWC(structs)
    np.testing.assert_array_equal(nat, jio.structsToNHWC(structs))
    py = imageIO.structsToNHWC(structs, dtype=np.float64).astype(np.float32)
    np.testing.assert_allclose(nat, py)
    assert np.allclose(nat[0][..., 3], arr[..., 3])
    assert np.allclose(nat[0][..., 0], arr[..., 2])
    back = imageIO.structsToNHWC(imageIO.nhwcToStructs(
        nat.astype(np.uint8)))
    np.testing.assert_allclose(back, nat)


def test_pack_images_bgra_alpha_preserved():
    rng = np.random.RandomState(3)
    b = rng.randint(0, 256, (2, 4, 4, 4)).astype(np.uint8)
    out = _pack(b, flip_bgr=True)
    assert np.allclose(out[..., 3], b[..., 3])
    assert np.allclose(out[..., 0], b[..., 2])
    assert np.allclose(out[..., 2], b[..., 0])


def test_pack_images_grayscale():
    rng = np.random.RandomState(4)
    b = rng.randint(0, 256, (3, 6, 6, 1)).astype(np.uint8)
    out = _pack(b, flip_bgr=True)
    assert np.allclose(out, b.astype(np.float32))


def test_bad_buffer_size_raises():
    for mod in (native, jnative):
        with pytest.raises(ValueError, match="expected"):
            mod.pack_images([b"abc"], [4], [4], 3, 4, 4)


def test_empty_batch():
    assert _pack_images([], [], [], 3, 4, 4).shape == (0, 4, 4, 3)


def test_numpy_fallback_agrees_uniform():
    rng = np.random.RandomState(5)
    b = rng.randint(0, 256, (3, 5, 5, 3)).astype(np.uint8)
    nat = _pack(b, flip_bgr=True, scale=2.0, offset=1.0)
    ref, jref = np.empty_like(nat), np.empty_like(nat)
    native._pack_images_numpy([b[i] for i in range(3)], [5] * 3, [5] * 3, 3,
                              ref, True, 2.0, 1.0)
    jnative._pack_images_numpy([b[i] for i in range(3)], [5] * 3, [5] * 3,
                               3, jref, True, 2.0, 1.0)
    np.testing.assert_array_equal(ref, jref)
    assert np.allclose(nat, ref, atol=1e-5)


def test_image_column_uses_native_path(monkeypatch):
    """The port's ``imageColumnToNHWC`` agrees with its pure-python path,
    and each path with the reference's."""
    import pyarrow as pa

    from sparkdl_tpu.image import imageIO as jio
    from sparkdl_tpu_torch.image import imageIO

    rng = np.random.RandomState(6)
    structs = [imageIO.imageArrayToStruct(
        rng.randint(0, 256, (7, 7, 3)).astype(np.uint8)) for _ in range(4)]
    col = pa.array(structs, type=imageIO._image_schema())
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("SPARKDL_TPU_NATIVE", flag)
        out[flag] = imageIO.imageColumnToNHWC(col)
        np.testing.assert_array_equal(out[flag], jio.imageColumnToNHWC(col))
    assert np.allclose(out["1"], out["0"], atol=1e-5)


def test_pack_images_rejects_nonuint8_arrays():
    for mod in (native, jnative):
        with pytest.raises(TypeError, match="uint8"):
            mod.pack_images([np.ones((4, 4, 3), np.float32)], [4], [4],
                            3, 4, 4)


def test_pack_images_u8_output_exact_and_rounds():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, size=(20, 30, 3)).astype(np.uint8)
    same = _pack_images([img.tobytes()], [20], [30], 3, 20, 30,
                        flip_bgr=True, dtype=np.uint8)
    assert same.dtype == np.uint8
    np.testing.assert_array_equal(same[0], img[:, :, ::-1])
    f32 = _pack_images([img.tobytes()], [20], [30], 3, 11, 17, flip_bgr=True)
    u8 = _pack_images([img.tobytes()], [20], [30], 3, 11, 17,
                      flip_bgr=True, dtype=np.uint8)
    assert np.abs(f32[0] - u8[0].astype(np.float32)).max() <= 0.5 + 1e-3


def test_pack_images_rejects_bad_dtype():
    for mod in (native, jnative):
        with pytest.raises(TypeError):
            mod.pack_images([b"\x00" * 3], [1], [1], 3, 1, 1,
                            dtype=np.float64)


def test_ensure_built_thread_safe_single_make(monkeypatch, tmp_path):
    """The port's ``ensure_built``: concurrent first use runs at most one
    build, and a make that leaves no library is a failure."""
    import sparkdl_tpu_torch.native as nat

    calls = []
    barrier = threading.Barrier(4, timeout=10)

    def fake_run(*a, **kw):
        calls.append(a)

        class R:
            returncode = 0
        return R()

    monkeypatch.setattr(nat, "_SO_PATH", str(tmp_path / "never_built.so"))
    monkeypatch.setattr(nat, "_build_failed", False)
    monkeypatch.setattr(nat.subprocess, "run", fake_run)
    results = []

    def worker():
        barrier.wait(30)
        results.append(nat.ensure_built())

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert results == [False] * 4
    assert len(calls) == 1
