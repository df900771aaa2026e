"""Build and load the port's CUDA kernels: ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.

A library is built at first use, and again when its source (or a header
beside it, or ``hopper.cuh`` here, which the wgmma kernels share) is newer
than the ``.so``, into ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``). The TMA kernels' tensor maps come from the
driver's ``cuTensorMapEncodeTiled``, fetched at run time through
``cudaGetDriverEntryPoint`` (``hopper.cuh``), so no library links
``-lcuda``. ``build_all`` starts one ``nvcc`` per source at once, so a
cold start pays for the slowest source, not the sum. Nothing here runs at
import time: the CPU tests import every module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"

_TOPK = KERNELS_DIR / "retrieval_topk" / "csrc"
# library name -> its one CUDA source (it may include headers beside it)
SOURCES: Dict[str, Path] = {
    "topk_int4": _TOPK / "topk_int4.cu",
    "topk_int4_gather": _TOPK / "topk_int4_gather.cu",
    "topk_dense": _TOPK / "topk_dense.cu",
    "flash_fwd": KERNELS_DIR / "flash_attention" / "csrc" / "flash_fwd.cu",
    "flash_bwd": KERNELS_DIR / "flash_attention" / "csrc" / "flash_bwd.cu",
    "int4_cache": KERNELS_DIR / "int4_cache" / "csrc" / "int4_cache.cu",
    "decode_attn": KERNELS_DIR / "decode_attention" / "csrc"
    / "decode_attn.cu",
    "moe_gemm": KERNELS_DIR / "moe_gemm" / "csrc" / "moe_gemm.cu",
    "moe_rows": KERNELS_DIR / "moe_gemm" / "csrc" / "moe_rows.cu",
    "split_gemm": KERNELS_DIR / "split_gemm" / "csrc" / "split_gemm.cu",
    "kda_fwd": KERNELS_DIR / "kda" / "csrc" / "kda_fwd.cu",
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# (library, seconds) of every build this process ran; chip_smoke.py prints it
BUILD_LOG: List[Tuple[str, float]] = []


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the port's CUDA kernels build from source")
    return found


def _so_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = _so_path(name)
    if not so.exists():
        return True
    src = SOURCES[name]
    newest = max(f.stat().st_mtime
                 for f in [src, *src.parent.glob("*.cuh"),
                           *KERNELS_DIR.glob("*.cuh")])
    return so.stat().st_mtime < newest


def _start(name: str) -> Tuple[subprocess.Popen, Path, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, time.perf_counter()


def _finish(name: str, proc: subprocess.Popen, tmp: Path, t0: float) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name].name}:\n{out}")
    os.replace(tmp, _so_path(name))  # atomic: readers never see a partial .so
    BUILD_LOG.append((name, time.perf_counter() - t0))
    (BUILD_DIR / f"lib{name}.ptxas.txt").write_text(out)


def build_all() -> None:
    """Build every stale library, all ``nvcc`` processes at once."""
    with _LOCK:
        started = [(n,) + _start(n) for n in SOURCES if _stale(n)]
        errors = []
        for name, proc, tmp, t0 in started:
            try:
                _finish(name, proc, tmp, t0)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if missing or stale."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if _stale(name):
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(_so_path(name)))
        _LIBS[name] = lib
        return lib


_SM_COUNT: Dict[int, int] = {}


def sm_count(device) -> int:
    """The SM count of a CUDA device, queried once per device
    (the decode step calls the kernels' wrappers every layer)."""
    import torch
    idx = (device if isinstance(device, torch.device)
           else torch.device(device)).index
    if idx is None:
        idx = torch.cuda.current_device()
    n = _SM_COUNT.get(idx)
    if n is None:
        n = _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
