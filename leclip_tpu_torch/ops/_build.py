"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by nvcc for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ctypes. Builds happen at
first use (or all at once, in parallel, through :func:`build_all`) into
``leclip_tpu_torch/_build/``, which git ignores. Library names carry a hash
of the flags, the source and every header it includes (followed through
``#include "..."``), so an edited source or header is rebuilt and never
loaded stale. Nothing here runs at import time."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_PF = ctypes.POINTER(ctypes.c_float)

# kernel library → (source, {C function: argtypes}); every function returns
# a cudaError_t as int, except the size queries (*_smem, *_bytes)
KERNELS: Dict[str, tuple] = {
    "attn_block_bf16": ("attn_block_bf16.cu", {
        "leclip_attn_block_bf16": [_P] * 10 + [_I] * 6 + [_F, _P],
        "leclip_attn_core_smem": [_I, _I],
    }),
    "mlp_bf16": ("mlp_bf16.cu", {
        "leclip_mlp_bf16": [_P] * 9 + [_I] * 3 + [_F, _P],
    }),
    "ln_quant": ("ln_quant.cu", {
        "leclip_ln_quant": [_P] * 5 + [_I] * 2 + [_F, _P],
    }),
    "attn_block_int8": ("attn_block_int8.cu", {
        "leclip_attn_block_int8": [_P] * 11 + [_I] * 6 + [_F, _P],
        "leclip_attn_core_smem": [_I, _I],
    }),
    "mlp_int8": ("mlp_int8.cu", {
        "leclip_mlp_int8": [_P] * 12 + [_I] * 3 + [_F, _P],
        "leclip_int8_exact_forms_check": [ctypes.c_ulonglong, _L, _P, _P],
    }),
    "resident_attention": ("resident_attention.cu", {
        "leclip_resident_attention": [_P] * 2 + [_I] * 6 + [_P],
        "leclip_resident_smem": [_I] * 3,
    }),
    "flash_attention": ("flash_attention.cu", {
        "leclip_flash_attention": [_P] * 6 + [_I] * 6 + [_L] * 9 + [_I, _P],
        "leclip_flash_scratch_bytes": [_I, _I],
    }),
    "conv_bf16": ("conv_bf16.cu", {
        "leclip_conv_bf16": [_P] * 6 + [_I] * 13 + [_P],
    }),
    "conv_fp32": ("conv_fp32.cu", {
        "leclip_conv_fp32": [_P] * 6 + [_I] * 13 + [_P],
        "leclip_conv_fp32_tile": [_L, _I],
    }),
    "resize_band": ("resize_band.cu", {
        "leclip_resize_band": [_P] * 4 + [_I] * 4 + [_L] + [_I] * 5 + [_PF, _PF, _P],
    }),
    "avg_pool_nhwc": ("avg_pool_nhwc.cu", {
        "leclip_avg_pool_nhwc": [_P] * 2 + [_I] * 6 + [_P],
    }),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.path.exists(path):
            return path
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(src: str) -> list:
    """``src`` and every csrc header it includes, directly or through another
    header, in a fixed order."""
    seen, todo = [], [src]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        todo += sorted(_INCLUDE.findall((CSRC / f).read_text()), reverse=True)
    return seen


def _lib_path(name: str) -> Path:
    src, _ = KERNELS[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in source_files(src):
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library, one nvcc per source, all started
    together. Returns {name: seconds} for the libraries built here; raises
    with nvcc's output when one fails. ptxas' register/spill report lands
    beside each library as ``.log``."""
    names = list(KERNELS if names is None else names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / KERNELS[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), tmp, out)
    times, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        times[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            failed.append(f"--- nvcc {n} (exit {p.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def build_log(name: str) -> str:
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in KERNELS[name][1].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_size_t if fn.endswith(("_smem", "_bytes")) else ctypes.c_int
            _libs[name] = lib
    return _libs[name]
