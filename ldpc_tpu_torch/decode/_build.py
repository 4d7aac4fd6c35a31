"""Build and load the port's CUDA kernels.

The sources under ``ldpc_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``ldpc_tpu_torch/_build/``, named by a
hash of the source and the flags, so it is built at first use and rebuilt
whenever either changes. A missing ``nvcc`` or a failed build raises.

Flags: ``-fmad=false`` and no ``--use_fast_math`` keep every float32
operation separately rounded and every division IEEE, so the f32 kernel
can match its plain PyTorch version bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_library", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "fused_layered.cu"
_BUILD = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# ldpc_fused_layered's C signature (csrc/fused_layered.cu)
_FUSED_ARGTYPES = [_P] * 8 + [_I, _P, _P, _I, _P, _P, _P, _P] + [_I] * 14 + [_P]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of ldpc_tpu_torch cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return _BUILD / f"fused_layered_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; the ptxas report of
    the build is kept beside it as ``<name>.log``."""
    so = library_path()
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.ldpc_fused_layered.argtypes = _FUSED_ARGTYPES
    lib.ldpc_fused_layered.restype = ctypes.c_int
    return lib
