"""Build and bind the CUDA kernels (nvcc into shared libraries with a plain C
interface, loaded with ctypes).

Each source in ``csrc/`` becomes its own ``lib<name>-<hash>.so`` under
``build/kernels/`` at the repository root; the hash covers the source, the
shared header and the flags, so an edited kernel rebuilds and an unchanged
one loads straight away. ``build_all`` starts one ``nvcc`` per source, all at
once, and waits for them together; it is called on first use, so a fresh
checkout builds its kernels itself. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention", "page_scores", "recall_gather", "recall_gather_quant",
           "page_summary", "flash_prefill")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signatures of the entry points; every one returns a cudaError_t as int
SIGNATURES = {
    "paged_attention": {
        "freekv_paged_attention": [_P] * 10 + [_I] * 7 + [_F, _F, _I, _I, _P],
    },
    "page_scores": {
        "freekv_page_scores": [_P] * 3 + [_I] * 5 + [_F, _I, _I, _P],
        "freekv_centroid_scores": [_P] * 4 + [_I] * 5 + [_F, _I, _I, _P],
    },
    "recall_gather": {
        "freekv_recall_gather": [_P] * 4 + [_I] * 4 + [_LL, _I, _I, _P],
        "freekv_recall_values": [_P] * 3 + [_I] * 4 + [_LL, _I, _I, _P],
        "freekv_recall_gather_blocks_per_sm": [_I, ctypes.POINTER(_I)],
        "freekv_device_pointer": [_P, _I, ctypes.POINTER(ctypes.c_void_p)],
    },
    "recall_gather_quant": {
        "freekv_recall_gather_quant": [_P] * 5 + [_I] * 11 + [_P],
        "freekv_recall_values_quant": [_P] * 4 + [_I] * 11 + [_P],
        "freekv_recall_gather_quant_blocks_per_sm": [_I, ctypes.POINTER(_I)],
    },
    "page_summary": {
        "freekv_page_summary": [_P] * 2 + [_I] * 5 + [_LL, _I, _I, _P],
    },
    "flash_prefill": {
        "freekv_flash_prefill": [_P] * 4 + [_I] * 5 + [ctypes.POINTER(_LL), _F, _F]
        + [_I] * 4 + [_P],
    },
}

_LIBS: dict = {}
BUILD_LOG: dict = {}


def nvcc_path():
    """The CUDA compiler, from PATH or the toolkit PyTorch was pointed at."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    return None


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all() -> float:
    """Compile every kernel source that has no current library, one nvcc
    process per source, all started together. Returns the seconds spent.
    Raises with the compiler's output when a build fails."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(CUDA tensors never fall back to the plain versions)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f".lib{name}-{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str):
    """The ctypes library of kernel source ``name``, building on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all()
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(rc: int, what: str):
    """Raise when a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
