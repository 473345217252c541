"""The port's native JPEG decoder (leclip_tpu_torch/runtime/jpeg.py +
decode.cpp, built with g++ against the libjpeg-turbo headers in
runtime/include/ and the ABI-62 libjpeg Pillow bundles) against PIL and the
JAX package's leclip_tpu/runtime/jpeg.py.

* Native = PIL = JAX's ``decode_batch``, bitwise, on files and on bytes, at
  several sizes and qualities, with 1 and 4 threads; PNG goes to PIL; the
  counters say which decoder took each image.
* ``ImageBatcher`` and ``decode_bytes_batch`` of the port's loader decode
  JPEGs natively (``native=False`` keeps PIL).
* The library passes its ABI check at load; two processes building into one
  empty directory at once both load a whole library.
* A hazard of the reference: the JAX package's ``decode_bytes_batch`` hands
  ``leclip_jpeg_dims`` a copy of each blob cut at its first NUL byte, so
  every JPEG there falls back to PIL; the port passes the blob itself."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from leclip_tpu.runtime import jpeg as jjpeg
from leclip_tpu_torch.data import loader as tloader
from leclip_tpu_torch.runtime import jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(120, 160, 92), (90, 90, 75), (201, 149, 95), (480, 640, 90), (1, 1, 90)]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w, q) in enumerate(SIZES):
        p = str(d / f"{i}.jpg")
        # smooth content plus noise: chroma subsampling and the IDCT both show
        base = np.linspace(0, 255, h * w * 3).reshape(h, w, 3)
        img = np.clip(base + rng.normal(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(p, quality=q)
        paths.append(p)
    gray = str(d / "gray.jpg")
    Image.fromarray(rng.integers(0, 255, (50, 70)).astype(np.uint8)).save(gray)
    png = str(d / "x.png")
    Image.fromarray(rng.integers(0, 255, (64, 48, 3)).astype(np.uint8)).save(png)
    return paths + [gray], png


def _pil(path):
    return np.asarray(Image.open(path).convert("RGB"))


def test_native_library_builds_and_passes_its_abi_check():
    assert jpeg.native_available(), jpeg.failure()
    cands = jpeg.libjpeg_candidates()
    assert cands and "pillow.libs" in cands[0]  # Pillow's own libjpeg comes first


@pytest.mark.parametrize("threads", [1, 4])
def test_native_equals_pil_and_jax_on_files_and_bytes(images, threads):
    paths, _ = images
    jpeg.reset_decode_counts()
    files = jpeg.decode_batch(paths, threads=threads)
    blobs = [open(p, "rb").read() for p in paths]
    mem = jpeg.decode_bytes_batch(blobs, threads=threads)
    assert jpeg.decode_counts() == {"native": 2 * len(paths), "pil": 0, "pil_jpeg": 0}
    ref_jax = jjpeg.decode_batch(paths, threads=threads)
    for p, a, b, c in zip(paths, files, mem, ref_jax):
        want = _pil(p)
        assert a.dtype == np.uint8 and a.shape == want.shape
        np.testing.assert_array_equal(a, want, err_msg=p)
        np.testing.assert_array_equal(b, want, err_msg=p)
        np.testing.assert_array_equal(np.asarray(c), want, err_msg=p)


def test_png_goes_to_pil(images):
    paths, png = images
    jpeg.reset_decode_counts()
    out = jpeg.decode_batch(paths[:2] + [png])
    np.testing.assert_array_equal(out[-1], _pil(png))
    assert jpeg.decode_counts() == {"native": 2, "pil": 1, "pil_jpeg": 0}
    assert jjpeg.decode_batch([png])[0].shape == out[-1].shape  # as JAX's fallback


def test_loader_decodes_natively(images):
    paths, png = images
    jpeg.reset_decode_counts()
    batcher = tloader.ImageBatcher(paths, batch_size=2)
    assert batcher.native
    got = [im for ims, _ in batcher for im in ims]
    assert jpeg.decode_counts() == {"native": len(paths), "pil": 0, "pil_jpeg": 0}
    pil_batcher = tloader.ImageBatcher(paths, batch_size=2, native=False)
    ref = [im for ims, _ in pil_batcher for im in ims]
    assert jpeg.decode_counts()["pil_jpeg"] == len(paths)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    jpeg.reset_decode_counts()
    blobs = [open(p, "rb").read() for p in paths[:3]] + [open(png, "rb").read()]
    out = tloader.decode_bytes_batch(blobs)
    assert jpeg.decode_counts() == {"native": 3, "pil": 1, "pil_jpeg": 0}
    for blob, o in zip(blobs, out):
        np.testing.assert_array_equal(o, np.asarray(Image.open(io.BytesIO(blob)).convert("RGB")))


def test_two_processes_building_at_once_both_load(images, tmp_path):
    paths, _ = images
    code = ("import sys, numpy as np; from PIL import Image; "
            "from leclip_tpu_torch.runtime import jpeg; "
            "lib = jpeg.load(sys.argv[1]); assert lib is not None, jpeg.failure(); "
            "a = jpeg.decode_bytes_batch([open(sys.argv[2], 'rb').read()])[0]; "
            "assert (a == np.asarray(Image.open(sys.argv[2]).convert('RGB'))).all(); "
            "print(jpeg.decode_counts()['native'])")
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build), paths[0]],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "1"
    files = os.listdir(build)
    assert len(files) == 1 and files[0].startswith("libleclip_decode-") and \
        files[0].endswith(".so")


def test_jax_decode_bytes_falls_back_to_pil_for_every_jpeg(images, monkeypatch):
    """The reference hazard: JAX's ``datas[i]`` reads back a bytes copy cut
    at the first NUL, so its header parse fails and PIL decodes every JPEG
    (its output is PIL's either way, and so without a library). The port
    decodes them natively."""
    paths, _ = images
    calls = []
    orig = jjpeg._pil_decode_bytes
    monkeypatch.setattr(jjpeg, "_pil_decode_bytes", lambda b: (calls.append(1), orig(b))[1])
    blobs = [open(p, "rb").read() for p in paths]
    jjpeg.decode_bytes_batch(blobs)
    assert len(calls) == len(blobs)
    jpeg.reset_decode_counts()
    jpeg.decode_bytes_batch(blobs)
    assert jpeg.decode_counts()["native"] == len(blobs)
