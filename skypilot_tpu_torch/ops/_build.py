"""Build the CUDA sources under ``csrc/`` with nvcc and load them.

Each ``.cu`` file becomes one shared library with a plain C interface,
loaded with ctypes (pointers and the stream as ``c_void_p``). nvcc runs at
first use, one process per source, all started together, into
``build/stpu_torch_kernels/<hash>/`` at the repo root; the hash covers the
sources, the headers and the flags, so a changed source rebuilds and a
fresh checkout builds on its own. Each C entry returns
``cudaGetLastError()`` after its launch and the wrapper raises on nonzero.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[2] / "build" /
              "stpu_torch_kernels")
SOURCES = ("flash_fwd", "flash_bwd", "flash_tri", "flash_streamed",
           "flash_f32")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# C signatures: (pointers..., strides, B, S, H, KVH, D, dtype, scale, causal,
# stream), dtype being the element type's code (DTYPES); the triangular
# family is causal only; every Hopper kernel (all but the fp32 kernels)
# takes its work list as the last pointer; the fp32 kernels take no dtype.
# The *_attrs entries fill five ints for a Hopper kernel at a head_dim and
# dtype: registers at launch, dynamic shared memory, threads, producer and
# consumer registers (setmaxnreg).
_TAIL = [_STRIDES, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
_TRI_TAIL = [_STRIDES, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
_F32_TAIL = [_STRIDES, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
_ATTRS = [_I, _I, ctypes.POINTER(_I)]
SIGNATURES = {
    "flash_fwd": {"stpu_flash_fwd": [_P] * 6 + _TAIL,
                  "stpu_flash_fwd_attrs": _ATTRS},
    "flash_bwd": {"stpu_flash_dq": [_P] * 9 + _TAIL,
                  "stpu_flash_dq_attrs": _ATTRS,
                  "stpu_flash_dkv": [_P] * 9 + _TAIL,
                  "stpu_flash_dkv_attrs": _ATTRS},
    "flash_tri": {"stpu_flash_fwd_tri": [_P] * 6 + _TRI_TAIL,
                  "stpu_flash_fwd_tri_attrs": _ATTRS,
                  "stpu_flash_dq_tri": [_P] * 9 + _TRI_TAIL,
                  "stpu_flash_dq_tri_attrs": _ATTRS,
                  "stpu_flash_dkv_tri": [_P] * 9 + _TRI_TAIL,
                  "stpu_flash_dkv_tri_attrs": _ATTRS},
    "flash_streamed": {"stpu_flash_fwd_streamed": [_P] * 6 + _TAIL,
                       "stpu_flash_fwd_streamed_attrs": _ATTRS,
                       "stpu_flash_dq_streamed": [_P] * 9 + _TAIL,
                       "stpu_flash_dq_streamed_attrs": _ATTRS,
                       "stpu_flash_dkv_streamed": [_P] * 9 + _TAIL,
                       "stpu_flash_dkv_streamed_attrs": _ATTRS},
    "flash_f32": {"stpu_flash_fwd_f32": [_P] * 5 + _F32_TAIL,
                  "stpu_flash_dq_f32": [_P] * 8 + _F32_TAIL,
                  "stpu_flash_dkv_f32": [_P] * 8 + _F32_TAIL},
}
# The element types the kernels have instances of, by the code the C
# entries take (csrc/flash_common.cuh: Bf16::kDtype, F16::kDtype).
DTYPES = {"bf16": 0, "f16": 1}

_LIBS: Dict[str, ctypes.CDLL] = {}
# Per source: seconds nvcc took in this process (0.0 when it was cached)
# and what ptxas reported (registers, shared memory, spills).
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the flash kernels are built on a "
                       "machine with the CUDA toolkit")


def build_dir() -> pathlib.Path:
    """Where this tree's sources and flags are built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, dict]:
    """Compile every source not yet built, in parallel; returns BUILD_INFO.
    A failed nvcc raises with its output."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    for n in SOURCES:
        if n not in todo:
            BUILD_INFO.setdefault(n, {"seconds": 0.0, "ptxas": ""})
    if not todo:
        return BUILD_INFO
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        # Built under a temporary name and renamed into place, so two
        # processes building at once never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[n] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode:
            failed.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out / f"lib{n}.so")
    if failed:
        raise RuntimeError("\n".join(failed))
    return BUILD_INFO


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_dir() / f"lib{name}.so"
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
