"""Build and bind the port's CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper (``sm_90a``) on
first CUDA use, one ``nvcc`` per source started together, and linked into one
shared library with a plain C interface that ``ctypes`` loads.  The library
lives under ``build/repro_torch/<hash>/`` at the repository root, keyed on a
hash of the sources and flags, so a changed source rebuilds and an unchanged
one is loaded as it is.  A failed build raises; nothing falls back.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("nbody.cu", "stencil5.cu", "flash_attention.cu", "ssd_scan.cu",
           "ssd_state_pass.cu", "card_gate.cu", "errors.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
CFLAGS = (ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIBNAME = "librepro_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U64 = ctypes.c_ulonglong
_SIGNATURES = {
    "repro_nbody_rows_f32": [_P, _P, _I, _I, _I, _F, _P],
    "repro_nbody_rows_f64": [_P, _P, _I, _I, _I, _F, _P],
    "repro_wave_rows_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "repro_wave_rows_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "repro_flash_fwd_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                            _I, _I, _I, _P],
    "repro_flash_fwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                             _I, _I, _I, _P],
    "repro_ssd_scan_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "repro_ssd_scan_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "repro_ssd_state_pass_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "repro_ssd_state_pass_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "repro_card_gate": [_P, _I, _U64, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if their hash is new) and return the library path.

    The compiler's output, ``-Xptxas -v`` register and spill counts included,
    is kept beside the library as ``build.log``."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIBNAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *CFLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        log = []
        failed = []
        for name, proc in zip(SOURCES, procs):
            text, _ = proc.communicate()
            log.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIBNAME
        link = subprocess.run(
            [nvcc, ARCH, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIBNAME} failed:\n{link.stdout}")
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "build.log").write_text("\n".join(log))
        os.replace(tmp_lib, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def direct(*tensors) -> bool:
    """Whether a launch may call its kernel directly and skip its custom
    op's dispatch (tens of microseconds a call): plain tensors, and no
    dispatch mode that watches the ops (``FlopCounterMode``,
    ``FakeTensorMode``, the dry-run's cost analysis).  Fake tensors and
    DTensors always go through the op."""
    import torch
    return (all(type(t) is torch.Tensor for t in tensors)
            and not torch._C._len_torch_dispatch_stack())
