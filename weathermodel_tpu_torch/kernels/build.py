"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` file is compiled for Hopper (`sm_90a`) into one shared
library with a plain C interface. The build runs at first use, outside any
import, into `build/kernels/<hash>/` under the checkout (listed in
`.gitignore`), keyed by a hash of the sources and the flags, so a changed
source rebuilds and an unchanged one is loaded from disk.

Each C entry point returns the `cudaError_t` of its launch; `check` raises
on anything but 0.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libwm_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float   # nvcc wall time; 0.0 when loaded from the cache
    ptxas_log: str   # nvcc's -Xptxas -v report (registers, smem, spills)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels are built on the GPU host")
    return path


def _declare(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.wm_fused_qkv_attention.argtypes = [i, p, p, p, p, i, i, i, i, p]
    lib.wm_fused_qkv_attention.restype = i
    lib.wm_cuda_error_string.argtypes = [i]
    lib.wm_cuda_error_string.restype = ctypes.c_char_p


@functools.lru_cache(maxsize=None)
def load_library() -> BuiltLibrary:
    """Compile (if not cached) and load the kernels' shared library."""
    sources = _sources()
    out_dir = BUILD_ROOT / _digest(sources)
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "ptxas.log"
    seconds = 0.0
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # build into a private name, then rename: concurrent processes (test
        # workers) never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _declare(lib)
    log = log_path.read_text() if log_path.exists() else ""
    return BuiltLibrary(lib, lib_path, seconds, log)


def check(err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load_library().lib.wm_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: error {err} ({msg})")
