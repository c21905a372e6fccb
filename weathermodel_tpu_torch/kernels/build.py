"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` file (with the `csrc/*.cuh` headers they include) is
compiled for Hopper (`sm_90a`), one nvcc process per file, all started
together, and linked into one shared library with a plain C interface. The
build runs at first use, outside any import, into `build/kernels/<hash>/`
under the checkout (listed in `.gitignore`), keyed by a hash of the sources
and the flags, so a changed source rebuilds and an unchanged one is loaded
from disk.

Each C entry point returns the `cudaError_t` of its launch; `check` raises
on anything but 0. `on_cuda` is the device rule every wrapper applies before
it calls one: which device, dtypes and head dims the library takes. Each
wrapper states its own layout rule beside it.
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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libwm_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the dtype argument of every entry point
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernels are instantiated for: mini/small/medium/large
KERNEL_HEAD_DIMS = (12, 20, 28, 36)


@dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float   # build wall time; 0.0 when loaded from the cache
    ptxas_log: str   # nvcc's -Xptxas -v report (registers, smem, spills)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(CSRC.glob("*.cuh"))]:
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
    u = ctypes.c_uint
    f = ctypes.c_float
    ll = ctypes.c_longlong
    # dtype, x, w, b, o, workspace, batch, t, h, heads, stream
    lib.wm_fused_qkv_attention.argtypes = [i, p, p, p, p, p, i, i, i, i, p]
    lib.wm_fused_qkv_attention.restype = i
    # dtype, x, w, b, o, qkv, workspace, batch, t, h, heads, dropout_on, seed,
    # threshold, keep_prob, stream
    lib.wm_fused_qkv_attention_train.argtypes = [i, p, p, p, p, p, p, i, i, i,
                                                 i, i, u, u, f, p]
    lib.wm_fused_qkv_attention_train.restype = i
    # dtype, qkv, do, dqkv, stats, workspace, batch, t, h, heads, dropout_on,
    # seed, threshold, inv_keep, stream
    lib.wm_fused_qkv_attention_bwd.argtypes = [i, p, p, p, p, p, i, i, i, i, i,
                                               u, u, f, p]
    lib.wm_fused_qkv_attention_bwd.restype = i
    # dtype, x, w, b, wo, bo, o (phase 1's output), y, workspace, offsets
    # {0, batch t} (bf16; None for fp32), batch, t, h, heads, dropout_on, seed,
    # threshold, keep_prob, stream
    lib.wm_fused_qkv_attention_outproj.argtypes = [i, p, p, p, p, p, p, p, p,
                                                   p, i, i, i, i, i, u, u, f,
                                                   p]
    lib.wm_fused_qkv_attention_outproj.restype = i
    # dtype, q, k, v, row stride, o, workspace, batch, t, h, heads, dropout_on,
    # seed, threshold, keep_prob, stream
    lib.wm_flash_attention.argtypes = [i, p, p, p, i, p, p, i, i, i, i, i, u,
                                       u, f, p]
    lib.wm_flash_attention.restype = i
    # (head dim, t) -> bf16 B3f's wgmma body's dynamic shared memory per block
    # in bytes, 0 where bf16 runs the scalar body
    lib.wm_flash_attention_wgmma_smem.argtypes = [i, i]
    lib.wm_flash_attention_wgmma_smem.restype = i
    # (head dim, t) -> fp32 B3f's FFMA body's dynamic shared memory per block
    # in bytes, 0 where fp32 runs the scalar body
    lib.wm_flash_attention_ffma_smem.argtypes = [i, i]
    lib.wm_flash_attention_ffma_smem.restype = i
    # dtype, q, k, v, row stride, do, dq, dk, dv, stats, workspace, batch, t,
    # h, heads, dropout_on, seed, threshold, inv_keep, stream
    lib.wm_flash_attention_bwd.argtypes = [i, p, p, p, i, p, p, p, p, p, p, i,
                                           i, i, i, i, u, u, f, p]
    lib.wm_flash_attention_bwd.restype = i
    # (dtype,) head dim, t -> the attention kernels' device workspace per
    # (batch row, head) block in bytes: 0 where the block keeps its rows on
    # chip, -1 where the kernels do not take t
    lib.wm_fused_qkv_attention_workspace.argtypes = [i, i, i]
    lib.wm_fused_qkv_attention_workspace.restype = ll
    lib.wm_flash_attention_workspace.argtypes = [i, i, i]
    lib.wm_flash_attention_workspace.restype = ll
    lib.wm_attention_bwd_workspace.argtypes = [i, i]
    lib.wm_attention_bwd_workspace.restype = ll
    # dtype, lhs, rhs, offsets, out, s, k, n, e, trans_rhs, stream
    lib.wm_gmm.argtypes = [i, p, p, p, p, i, i, i, i, i, p]
    lib.wm_gmm.restype = i
    # dtype, lhs, dy, offsets, out, s, k, n, e, stream
    lib.wm_tgmm.argtypes = [i, p, p, p, p, i, i, i, i, p]
    lib.wm_tgmm.restype = i
    # the bf16 grouped-matmul body's (B4, B4t, P3, B5's phase 2, B6b's weight
    # gradients) dynamic shared memory per block in bytes
    lib.wm_gmm_wgmma_smem.argtypes = []
    lib.wm_gmm_wgmma_smem.restype = i
    # dtype, x, w1, b1, w2, b2, f, h (or None), m, h, f, dropout_on, seed1,
    # seed2, threshold, inv_keep, stream
    lib.wm_fused_ffn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, u, u, u,
                                 f, p]
    lib.wm_fused_ffn.restype = i
    # dtype, x, w1, b1, w2, b2, ln_scale, ln_bias, out, m, h, f, dropout_on,
    # seed1, seed2, threshold, keep_prob, stream
    lib.wm_fused_ffn_ln.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, u,
                                    u, u, f, p]
    lib.wm_fused_ffn_ln.restype = i
    # h -> the bf16 FFN body's dynamic shared memory per block, in bytes
    lib.wm_ffn_wgmma_smem.argtypes = [i]
    lib.wm_ffn_wgmma_smem.restype = i
    # (head dim, t) -> the bf16 attention body's dynamic shared memory per
    # block in bytes, 0 where it does not take t
    lib.wm_qkv_attention_wgmma_smem.argtypes = [i, i]
    lib.wm_qkv_attention_wgmma_smem.restype = i
    # (head dim, t) -> the bf16 attention backward body's (B2, B3b) dynamic
    # shared memory per block in bytes, 0 where bf16 runs the scalar passes
    lib.wm_attention_bwd_wgmma_smem.argtypes = [i, i]
    lib.wm_attention_bwd_wgmma_smem.restype = i
    # (head dim, t) -> the fp32 attention backward body's (B2, B3b) dynamic
    # shared memory per block in bytes (the larger pass's), 0 where fp32 runs
    # the scalar passes
    lib.wm_attention_bwd_ffma_smem.argtypes = [i, i]
    lib.wm_attention_bwd_ffma_smem.restype = i
    # dtype, x, w1, b1, w2, b2, ln_scale, do, dx, dw1, db1, dw2, db2,
    # dln_scale, dln_bias, scratch hd, df, dy, dz, ln_part, w_part, m, h, f,
    # dropout_on, seed1, seed2, threshold, inv_keep, splits1, splits2, stream
    lib.wm_fused_ffn_ln_bwd.argtypes = [i, *[p] * 20, i, i, i, i, u, u, u, f,
                                        i, i, p]
    lib.wm_fused_ffn_ln_bwd.restype = i
    # (h, f) -> bf16 B6b's row body's dynamic shared memory per block in
    # bytes, 0 where it does not take them
    lib.wm_ffn_bwd_wgmma_smem.argtypes = [i, i]
    lib.wm_ffn_bwd_wgmma_smem.restype = i
    # out, m, c, seed, threshold, stream (B9b: bool [m, c]; B9p: int32
    # [m / 32, c])
    lib.wm_bool_keep_mask.argtypes = [p, i, i, u, u, p]
    lib.wm_bool_keep_mask.restype = i
    lib.wm_packed_keep_mask.argtypes = [p, i, i, u, u, p]
    lib.wm_packed_keep_mask.restype = i
    # out, n, seed, threshold, stream (B8m)
    lib.wm_random_keep_mask.argtypes = [p, ctypes.c_longlong, u, u, p]
    lib.wm_random_keep_mask.restype = i
    # dtype, x, y, n, seed, threshold, scale, stream (B8)
    lib.wm_lane_dropout.argtypes = [i, p, p, ctypes.c_longlong, u, u, f, p]
    lib.wm_lane_dropout.restype = i
    # q, k, v, o, batch, t, h, stream (P1, P2; bfloat16 only)
    for fn in (lib.wm_headpack_v0, lib.wm_headpack_v1):
        fn.argtypes = [p, p, p, p, i, i, i, p]
        fn.restype = i
    # dtype, x, w, offsets {0, covered rows} (bf16; None for fp32), y,
    # covered rows, k, n, covered columns, stream (P3)
    lib.wm_blocked_mm.argtypes = [i, p, p, p, p, i, i, i, i, p]
    lib.wm_blocked_mm.restype = i
    lib.wm_cuda_error_string.argtypes = [i]
    lib.wm_cuda_error_string.restype = ctypes.c_char_p


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _wait(cmd, proc) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(map(str, cmd))}\n{out}")
    return out


def _compile(sources, tmp: Path) -> str:
    """One nvcc per source, all started together, then one link; returns
    their output (the ptxas report)."""
    nvcc = _nvcc()
    objects = [tmp / (src.stem + ".o") for src in sources]
    procs = [_start([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src])
             for src, obj in zip(sources, objects)]
    try:
        log = "".join(_wait(cmd, proc) for cmd, proc in procs)
    finally:
        for _, proc in procs:  # after a failure, stop the others too
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp / LIB_NAME, *objects]
    return log + _wait(*_start(link))


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
        # build in a private directory, then rename the library into place:
        # concurrent processes (test workers) never load a half-written one
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            log = _compile(sources, Path(tmp))
            os.replace(Path(tmp) / LIB_NAME, lib_path)
        seconds = time.perf_counter() - t0
        log_path.write_text(log)
    lib = ctypes.CDLL(str(lib_path))
    _declare(lib)
    log = log_path.read_text() if log_path.exists() else ""
    return BuiltLibrary(lib, lib_path, seconds, log)


def check(err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load_library().lib.wm_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: error {err} ({msg})")


def device_on_cuda(device: torch.device) -> bool:
    """False for the CPU (the plain version runs), True for a CUDA device;
    raises on anything else."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return True


def on_cuda(name, head_dim, *tensors) -> bool:
    """False for CPU tensors (the plain version runs); True for CUDA
    tensors of one dtype and a head dim the kernels take (None for kernels
    without heads); raises on anything else. Layout is each wrapper's own
    check."""
    devices = {a.device for a in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    if not device_on_cuda(devices.pop()):
        return False
    dtypes = {a.dtype for a in tensors}
    if len(dtypes) != 1 or tensors[0].dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: inputs must share one dtype of "
                         f"float32/bfloat16, got {[a.dtype for a in tensors]}")
    if head_dim is not None and head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not in the kernel's "
                         f"instantiations {KERNEL_HEAD_DIMS}")
    return True


def cuda_stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def workspace(per_block: int, blocks: int, device):
    """A kernel's device workspace: `blocks` blocks of the bytes its library
    query returned for one block, or None (a null pointer) where that is 0.
    Allocated with torch.empty on the caller's stream, as every scratch."""
    if per_block < 0:
        raise ValueError("the kernels do not take this shape (workspace "
                         "query returned -1)")
    if per_block == 0:
        return None
    return torch.empty(per_block * blocks, dtype=torch.uint8, device=device)


def data_ptr(a):
    """a.data_ptr(), or None (a null pointer) for None."""
    return None if a is None else a.data_ptr()
