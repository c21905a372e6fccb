"""Fused QKV projection + multi-head self-attention (eval form).

Port of `flash_attention_fused` (weathermodel_tpu/ops/pallas_attention.py)
with dropout 0. On a CUDA tensor `fused_qkv_attention` launches the
hand-written Hopper kernel in `csrc/fused_qkv_attention.cu`; on a CPU tensor
it runs `fused_qkv_attention_reference`, the same computation in plain
PyTorch ops, which is also what the kernel is checked against on the card.

Numerics (both versions, as the TPU kernel): qkv = x . w^T + b accumulated
in fp32 and rounded to x's dtype; scores q . k^T / sqrt(hd) in fp32; a
max-subtracted fp32 softmax whose weights are rounded to x's dtype; p . v
accumulated in fp32; the output in x's dtype.
"""

import torch

from weathermodel_tpu_torch.kernels import build
from weathermodel_tpu_torch.ops.attention import torch_attention

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernel is instantiated for: mini/small/medium/large
KERNEL_HEAD_DIMS = (12, 20, 28, 36)


def _check_shapes(x, w_qkv, b_qkv, num_heads):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, H], got {tuple(x.shape)}")
    h = x.shape[-1]
    if h % num_heads != 0:
        raise ValueError(f"hidden {h} not divisible by heads {num_heads}")
    if tuple(w_qkv.shape) != (3 * h, h) or tuple(b_qkv.shape) != (3 * h,):
        raise ValueError(
            f"w_qkv must be [{3 * h}, {h}] and b_qkv [{3 * h}], got "
            f"{tuple(w_qkv.shape)} and {tuple(b_qkv.shape)}")


def fused_qkv_attention_reference(x, w_qkv, b_qkv, num_heads: int):
    """Plain PyTorch version of the kernel. x [B, T, H]; w_qkv [3H, H]
    (torch [out, in] layout); b_qkv [3H]; returns [B, T, H] in x.dtype."""
    _check_shapes(x, w_qkv, b_qkv, num_heads)
    qkv = (x.float() @ w_qkv.float().T + b_qkv.float()).to(x.dtype)
    return torch_attention(*qkv.chunk(3, dim=-1), num_heads)


def fused_qkv_attention(x, w_qkv, b_qkv, num_heads: int):
    """x [B, T, H]; w_qkv [3H, H]; b_qkv [3H] -> [B, T, H].

    CUDA tensors launch the kernel (and count the launch in
    `fused_qkv_attention.launches`) or raise; CPU tensors take the plain
    version."""
    _check_shapes(x, w_qkv, b_qkv, num_heads)
    devices = {x.device, w_qkv.device, b_qkv.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    if x.device.type == "cpu":
        return fused_qkv_attention_reference(x, w_qkv, b_qkv, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES or {w_qkv.dtype, b_qkv.dtype} != {x.dtype}:
        raise ValueError(
            f"x, w_qkv and b_qkv must share one dtype of float32/bfloat16, "
            f"got {x.dtype}, {w_qkv.dtype}, {b_qkv.dtype}")
    if not (x.is_contiguous() and w_qkv.is_contiguous()
            and b_qkv.is_contiguous()):
        raise ValueError("fused_qkv_attention needs contiguous inputs")
    bsz, t, h = x.shape
    if h // num_heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {h // num_heads} not in the kernel's "
                         f"instantiations {KERNEL_HEAD_DIMS}")
    lib = build.load_library().lib
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.wm_fused_qkv_attention(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w_qkv.data_ptr(),
            b_qkv.data_ptr(), out.data_ptr(), bsz, t, h, num_heads, stream)
    build.check(err)
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0
