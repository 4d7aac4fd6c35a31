"""Build and load the port's CUDA kernels.

Every ``*.cu`` source under ``ldpc_tpu_torch/csrc/`` is compiled with
``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all started together;
the objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``. The library lands in ``ldpc_tpu_torch/_build/``,
named by a hash of all the sources (``*.cu`` and ``*.cuh``) and the flags,
so it is built at first use and rebuilt whenever any of them changes. A
missing ``nvcc`` or a failed build raises. ``build_library`` and
``open_library`` build and load another source tree the same way (for
timing kernels against an older commit, ``tests_gpu/time_kernels.py``).

Flags: ``-fmad=false`` and no ``--use_fast_math`` keep every float32
operation separately rounded and every division IEEE, so the f32 kernels
can match their plain PyTorch versions bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_library", "library_path", "build_library", "open_library",
           "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C signatures of the kernels' entry points
_ARGTYPES = {
    # csrc/fused_layered.cu
    "ldpc_fused_layered":
        [_P] * 8 + [_I, _P, _P, _I, _P, _P, _P, _P] + [_I] * 15 + [_P],
    "ldpc_fused_layered_smem": [_I] * 11,
    "ldpc_fused_layered_state_bytes": [_I] * 10,
    "ldpc_fused_layered_occupancy": [_I] * 12,
    # csrc/fused_flooding.cu
    "ldpc_fused_flooding":
        [_P] * 7 + [_I, _P, _P, _I, _P] + [_P] * 5 + [_I] * 14 + [_P],
    "ldpc_fused_flooding_smem": [_I] * 9,
    "ldpc_fused_flooding_occupancy": [_I] * 10,
    # csrc/qc_cn.cu
    "ldpc_qc_cn": [_P] * 5 + [_I, _P, _P] + [_I] * 11 + [_P],
    "ldpc_qc_cn_occupancy": [_I] * 4,
    # csrc/qc_vn.cu
    "ldpc_qc_vn": [_P] * 6 + [_I, _P, _P] + [_I] * 11 + [_P],
    "ldpc_qc_vn_occupancy": [_I] * 3,
    "ldpc_powf_one_mismatches": [_P, ctypes.c_float, _P],
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of ldpc_tpu_torch cannot be built")


def library_path(csrc: Path = _CSRC, build: Path = _BUILD) -> Path:
    """Where the library of the sources in ``csrc`` is built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(Path(csrc).glob("*.cu*")):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return Path(build) / f"ldpc_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Start every command at once; raise on the first that fails.
    Returns their combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build_library(csrc: Path = _CSRC, build: Path = _BUILD) -> Path:
    """Build the library of every ``*.cu`` in ``csrc`` into ``build``
    (unless it is there) and return its path; the ptxas report of the
    build is kept beside it as ``<name>.log``."""
    so = library_path(csrc, build)
    if not so.exists():
        sources = sorted(Path(csrc).glob("*.cu"))
        so.parent.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{so.stem}.{os.getpid()}"
        objs = [so.parent / f"{tag}.{src.stem}.o" for src in sources]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                        for src, o in zip(sources, objs)])
        tmp = so.with_name(f"{tag}.tmp.so")
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                          *map(str, objs)]])
        for o in objs:
            o.unlink()
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
    return so


def open_library(so: Path, strict: bool = True) -> ctypes.CDLL:
    """Load a built library and declare its entry points; with ``strict``
    False, those it lacks (a library of older sources) are skipped."""
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _ARGTYPES.items():
        if not strict and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the package's kernel library."""
    return open_library(build_library())
