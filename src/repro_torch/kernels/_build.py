"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into its own shared library
with a plain C interface, which is loaded with ``ctypes``.  All sources
compile at once (one ``nvcc`` process each, started together) at first use,
into ``build/repro_torch/`` at the root of the checkout; a library's file
name carries a hash of its source, header and flags, so an edit rebuilds it
and an unchanged source is reused.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per-source extra flags: the encode step must not contract into FMAs
_EXTRA = {"clip_quant_mask": ("--fmad=false",)}

_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signature of every exported entry point: (library, symbol) -> (restype, argtypes)
_SIGNATURES = {
    ("staleness_agg", "rt_staleness_agg"): (_i, (_p, _p, _p, _i, _ll, _i, _p)),
    ("masked_agg", "rt_masked_agg"): (_i, (_p, _p, _p, _i, _ll, _f, _i, _p)),
    ("clip_quant_mask", "rt_clip_quant_mask"):
        (_i, (_p, _p, _p, _p, _i, _ll, _ll, _f, _f, _i, _p)),
    ("clip_quant_mask", "rt_clip_quant_mask_tiles"): (_ll, (_ll,)),
}
KERNELS = ("staleness_agg", "masked_agg", "clip_quant_mask")

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # kernel -> nvcc's output (ptxas register/spill report)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update((_CSRC / f"{name}.cu").read_bytes())
    h.update((_CSRC / "common.cuh").read_bytes())
    h.update(" ".join(_FLAGS + _EXTRA.get(name, ())).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel library that is missing; returns the seconds it
    took.  Raises with nvcc's output if any compile fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in KERNELS:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, *_EXTRA.get(name, ()), "-I", str(_CSRC),
               "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it at first use."""
    if name not in _libs:
        if not _target(name).exists():
            build_all()
        cdll = ctypes.CDLL(str(_target(name)))
        for (lib_name, sym), (restype, argtypes) in _SIGNATURES.items():
            if lib_name == name:
                fn = getattr(cdll, sym)
                fn.restype, fn.argtypes = restype, list(argtypes)
        _libs[name] = cdll
    return _libs[name]
