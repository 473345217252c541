"""ctypes binding of the port's native JPEG decoder (decode.cpp; the port's
own copy of leclip_tpu/runtime/jpeg.py).

``decode_batch(paths)`` / ``decode_bytes_batch(blobs)``: a header parse for
each image's size, exact numpy buffers, then one multithreaded native call
that decodes straight into them. The output is PIL's, bit for bit: the
library is linked against the very libjpeg Pillow decodes with.

The build uses only what is in the repository and on the machine. The four
libjpeg-turbo headers (JPEG ABI 62) and their licence are in ``include/``;
the library linked against is the first ``libjpeg*.so.62*`` in the
``pillow.libs`` directory beside PIL's package (Pillow's wheel bundles
one), else the system's ``libjpeg.so.62``, with an rpath to its directory.
g++ builds it at first use into ``leclip_tpu_torch/_build/`` (git ignores
it) under a name that carries a hash of the source, the headers and the
library, written under a temporary name and moved into place, so processes
that build at once each load a whole library. At load the library's ABI is
checked against the headers' (``leclip_jpeg_abi``).

Without a library or g++ the decoder falls back to PIL, as the JAX
package's does, but says so once; and every image counts which decoder took
it (:func:`decode_counts`): ``native``, ``pil``, and ``pil_jpeg``, the JPEGs
among the PIL decodes, which a run that must decode natively requires to
stay 0. Non-JPEG input (PNG, ...) always goes to PIL."""

from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import io
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE / "decode.cpp"
INCLUDE = HERE / "include"
BUILD_DIR = HERE.parent / "_build"

_lock = threading.Lock()
_libs: Dict[str, object] = {}   # build dir → CDLL, or None when unavailable
_counts = {"native": 0, "pil": 0, "pil_jpeg": 0}
_count_lock = threading.Lock()
_failure: Optional[str] = None


def _count(kind: str, n: int = 1) -> None:
    with _count_lock:
        _counts[kind] += n


def decode_counts() -> dict:
    """Images decoded since the last reset: {"native", "pil", "pil_jpeg"}."""
    with _count_lock:
        return dict(_counts)


def reset_decode_counts() -> None:
    with _count_lock:
        for k in _counts:
            _counts[k] = 0


def libjpeg_candidates() -> List[str]:
    """ABI-62 libjpeg libraries on this machine, in order of preference:
    the one in Pillow's ``pillow.libs`` (the library PIL decodes with), then
    the system's."""
    found = []
    spec = importlib.util.find_spec("PIL")
    if spec is not None and spec.submodule_search_locations:
        libs = Path(list(spec.submodule_search_locations)[0]).parent / "pillow.libs"
        found += sorted(glob.glob(str(libs / "libjpeg*.so.62*")))
    for d in ("/usr/lib/x86_64-linux-gnu", "/lib/x86_64-linux-gnu", "/usr/lib64", "/usr/lib"):
        found += sorted(glob.glob(os.path.join(d, "libjpeg.so.62*")))
    return list(dict.fromkeys(found))


def _library_name(libjpeg: str) -> str:
    h = hashlib.sha256()
    for part in [SRC] + sorted(INCLUDE.glob("*.h")):
        h.update(part.read_bytes())
    h.update(os.path.realpath(libjpeg).encode())
    return f"libleclip_decode-{h.hexdigest()[:16]}.so"


def build(libjpeg: str, build_dir: Path = BUILD_DIR) -> Path:
    """Compile decode.cpp against ``libjpeg`` (once: the name carries the
    hash of the inputs). Written to a temporary name, then moved into
    place."""
    build_dir = Path(build_dir)
    out = build_dir / _library_name(libjpeg)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = build_dir / f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    libdir = os.path.dirname(os.path.realpath(libjpeg))
    cmd = ["g++", "-O3", "-shared", "-fPIC", f"-I{INCLUDE}", "-o", str(tmp), str(SRC),
           os.path.realpath(libjpeg), f"-Wl,-rpath,{libdir}", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.leclip_jpeg_abi.restype = ctypes.c_int
    lib.leclip_jpeg_abi.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)]
    lib.leclip_jpeg_dims.restype = ctypes.c_int
    lib.leclip_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.leclip_decode_jpeg_batch.restype = ctypes.c_int
    lib.leclip_decode_jpeg_batch.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    version, size = ctypes.c_int(), ctypes.c_long()
    rc = lib.leclip_jpeg_abi(ctypes.byref(version), ctypes.byref(size))
    if rc != 0:
        raise RuntimeError(f"{path.name}: the library refuses JPEG ABI {version.value} with a "
                           f"{size.value}-byte decompress struct (libjpeg message {rc})")
    return lib


def load(build_dir: Path = BUILD_DIR):
    """The bound library, built at first use; None (after one printed line
    saying why) when no candidate library builds, loads and passes the ABI
    check."""
    global _failure
    key = str(build_dir)
    with _lock:
        if key in _libs:
            return _libs[key]
        errors = []
        for cand in libjpeg_candidates():
            try:
                _libs[key] = _bind(build(cand, build_dir))
                return _libs[key]
            except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
                detail = getattr(e, "stderr", "") or str(e)
                errors.append(f"{cand}: {detail.strip()[:300]}")
        _libs[key] = None
        _failure = "; ".join(errors) or "no libjpeg.so.62 found (pillow.libs, system)"
        print(f"native JPEG decoder unavailable ({_failure}); decoding with PIL")
        return None


def native_available() -> bool:
    return load() is not None


def failure() -> Optional[str]:
    """Why the native decoder is unavailable (None when it loaded)."""
    return _failure


def pil_decode(source) -> np.ndarray:
    """PIL decode of a path or a file object → uint8 RGB [H, W, 3], counted."""
    from PIL import Image

    with Image.open(source) as im:
        _count("pil")
        if im.format == "JPEG":
            _count("pil_jpeg")
        return np.asarray(im.convert("RGB"), np.uint8)


def decode_batch(paths: Sequence[str], threads: int = 8) -> List[np.ndarray]:
    """Decode image files → list of [H, W, 3] uint8 arrays (native for
    JPEGs when the library loaded; other formats and failed files by
    PIL)."""
    if load() is None:
        return [pil_decode(p) for p in paths]
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    return decode_bytes_batch(blobs, threads)


def decode_bytes_batch(blobs: Sequence[bytes], threads: int = 8) -> List[np.ndarray]:
    """Decode in-memory images (the serving path: no filesystem round trip),
    with the same native / PIL split as :func:`decode_batch`."""
    lib = load()
    if lib is None:
        return [pil_decode(io.BytesIO(b)) for b in blobs]
    n = len(blobs)
    hs, ws, rc = (ctypes.c_int * n)(), (ctypes.c_int * n)(), (ctypes.c_int * n)()
    datas = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    caps, ptrs = (ctypes.c_long * n)(), (ctypes.c_void_p * n)()
    outs: List[Optional[np.ndarray]] = []
    for i in range(n):
        h, w = ctypes.c_int(), ctypes.c_int()
        # the bytes object itself: ``datas[i]`` would read back a copy cut
        # at the blob's first NUL byte
        if lib.leclip_jpeg_dims(blobs[i], len(blobs[i]), ctypes.byref(h), ctypes.byref(w)) != 0:
            outs.append(None)  # not a JPEG: PIL below
            buf = np.zeros(1, np.uint8)
        else:
            buf = np.empty((h.value, w.value, 3), np.uint8)
            outs.append(buf)
        caps[i] = buf.nbytes
        ptrs[i] = buf.ctypes.data_as(ctypes.c_void_p)
    lib.leclip_decode_jpeg_batch(n, datas, lens, ptrs, caps, hs, ws, rc, threads)
    result = []
    for i in range(n):
        if outs[i] is None or rc[i] != 0:
            result.append(pil_decode(io.BytesIO(blobs[i])))
        else:
            _count("native")
            result.append(outs[i])
    return result
