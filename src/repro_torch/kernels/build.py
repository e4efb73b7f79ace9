"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The kernels are compiled at first use, from the sources in this
package, with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. Every
source compiles in its own ``nvcc`` process, all started together, and
one more ``nvcc`` links them. The library's name carries a digest of the
sources and flags, so an edited source never loads a stale build.

The build goes to ``build/repro_torch_kernels/`` under the repository
root (``REPRO_TORCH_BUILD_DIR`` overrides it). Nothing here runs at
import: importing the kernels on a machine without ``nvcc`` works, and
only a launch on a CUDA tensor needs the library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("sort.cu", "coalesce_kernel.cu", "fused_round.cu",
           "zero_skip.cu", "pack.cu", "route_spans.cu", "flash.cu",
           "flash_decode.cu", "flash_bwd.cu")
HEADERS = ("common.cuh", "bitonic.cuh", "tile_walk.cuh", "pack_tiles.cuh",
           "flash_tiles.cuh", "flash_wgmma.cuh", "flash_mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "repro_bitonic_sort": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "repro_coalesce": (_P, _P, _P, _P, _P, _I, _I, _P),
    "repro_coalesce_max_active_clusters": (_I, _P),
    "repro_fused_sort_pack": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _LL, _LL, _I, ctypes.c_ulonglong, _P),
    "repro_zero_skip_encode": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "repro_zero_skip_decode": (_P, _P, _P, _I, _I, _I, _P),
    "repro_pack": (_P, _P, _P, _P, _P, _P, _I, _LL, _LL, _I, _P),
    "repro_route_spans": (_P, _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _P),
    "repro_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _F, _I, _I, _F, _I, _I, _I, _I, _I, _P),
    "repro_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _F, _I, _I, _F, _I,
                                  _I, _I, _I, _I, _P),
}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDACXX"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDACXX or put nvcc on PATH); the CUDA "
        "kernels of repro_torch are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_library() -> tuple[Path, float]:
    """Compile the kernels unless this digest is already built.
    Returns ``(library path, seconds spent building)``; the compiler's
    resource report (``-Xptxas -v``) is kept beside each object as
    ``<source>.log``."""
    out = build_dir()
    lib = out / f"librepro_torch_kernels-{_digest()}.so"
    if lib.is_file():
        return lib, 0.0
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = out / f"{Path(name).stem}-{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name),
               "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, obj, proc in procs:
        log, _ = proc.communicate()
        (out / f"{Path(name).stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C
    function's argument and return types declared."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} failed: CUDA error {code} ({msg})")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors, dtype=None) -> None:
    """The checks a launch needs: every tensor on one CUDA device and
    contiguous, and of ``dtype`` where one is given. Raises otherwise —
    a CUDA tensor either reaches its kernel or fails loudly."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device; "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
