"""Int8 (W8A8) matmuls for the serving path (port of
weathermodel_tpu/ops/quant.py).

Two schemes, as in the JAX package:

  * DYNAMIC (`int8_dense`, `ffn_impl="int8"`): per-row activation absmax
    computed on the fly, per-output-channel weight absmax.
  * STATIC (`int8_dense_static` / `int8_expert_einsum`,
    `ffn_impl="int8_static"`, `wm-serve-torch --quantize int8_static`):
    per-channel activation absmax calibrated offline
    (serve.calibrate_quant_scales) and folded into the weight before its
    quantization, x @ w == (x / s) @ (diag(s) w), so the serving-time
    activation pass is one elementwise scale, round and clip with no
    reduction. Activations beyond the calibrated range saturate at +-127.

Weights quantize per output channel, symmetric absmax, on every call.
Rounding is half to even (`torch.round`, as `jnp.round`); a scale is the
absmax times fp32 1/127 (the product XLA makes of the JAX package's
division by the constant 127 under jit), the division by a scale is one
fp32 operation, and the dequantizing product and bias sum round once, as
the FMA XLA makes of them (`_dequant`); so the int8 codes and the
dequantized outputs are the jitted JAX package's bit for bit on the same
inputs. The products accumulate exactly in int32: `torch._int_mm` (int8 x
int8 -> int32, cuBLASLt) on a CUDA tensor, an int32 matmul on the CPU. No
TPU kernel computes these products (they are XLA dots in the JAX package),
so the library GEMM stands for them as `torch.matmul` stands for XLA's
float dots. `torch._int_mm` takes more than 16 rows and K and N multiples
of 8 on the card; on another shape the wrapper raises naming it, and never
falls back to a float matmul.

The weights here are in torch's [out, in] layout for the dense forms (an
`nn.Linear`'s weight) and in the JAX layout [E, K, O] for the experts (the
port's MoE parameters, models/moe.py).

`set_attn_out_quant` (or `WM_QUANT_ATTN_OUT=1` in the environment) extends
int8_static to the attention out-projection, calibration and serving both
(models/blocks.py reads it at each forward), as the JAX switch does.
"""

import os

import torch

_EPS = 1e-8
# 1/127 in fp32: XLA compiles the JAX package's absmax / 127.0 under jit as
# a product with the constant's fp32 reciprocal, and so does the port
_INV_127 = (torch.tensor(1.0) / 127.0).item()


def _floor(amax):
    """max(amax, 1e-8) in amax's dtype, then fp32: the JAX package's order
    (jnp.maximum with a weakly typed 1e-8, then astype)."""
    floor = torch.tensor(_EPS, dtype=amax.dtype).item()
    return amax.clamp_min(floor).float()


def _absmax_scale(x, dim):
    """Symmetric absmax scale with keepdim such that x / scale fits int8
    [-127, 127]."""
    return _floor(x.abs().amax(dim=dim, keepdim=True)) * _INV_127


def _codes(x, scale):
    """clip(round(x / scale), -127, 127) as int8; x / scale in fp32."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def quantize_int8(x, dim):
    """-> (q int8, scale fp32 with keepdim) so that q * scale ~= x."""
    scale = _absmax_scale(x, dim)
    return _codes(x, scale), scale


def _check_int_mm(a, b):
    m, k = a.shape
    n = b.shape[1]
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(
            f"int8 matmul [{m}, {k}] x [{k}, {n}] on {a.device}: "
            "torch._int_mm takes more than 16 rows and K and N multiples "
            "of 8")


def int_mm(a, b):
    """Exact int32 a @ b of int8 a [M, K] and b [K, N]: `torch._int_mm` on a
    CUDA tensor (raising on a shape it does not take), an int32 matmul on
    the CPU."""
    if a.device.type == "cuda":
        _check_int_mm(a, b)
        return torch._int_mm(a, b)
    if a.device.type != "cpu":
        raise ValueError(f"int8 matmul on {a.device}: cuda or cpu only")
    return a.to(torch.int32) @ b.to(torch.int32)


def _dequant(p, scale, b, out_dtype):
    """p * scale (+ b) in fp32, then in `out_dtype`. With a bias it is one
    rounding of the exact p * scale + b, the FMA that XLA makes of the JAX
    package's product and sum: the fp32 product is exact in fp64 and the
    fp64 sum is rounded to fp32 (it differs from the FMA only where that
    sum lies exactly halfway between two fp32 values, about 2^-29 of the
    outputs), the same on the card and on the CPU."""
    if b is None:
        return (p * scale).to(out_dtype)
    y = torch.addcmul(b.double(), p.double(), scale.double())
    return y.float().to(out_dtype)


def int8_dense(x, w, b=None, out_dtype=None):
    """y = x @ w^T (+ b) with dynamic per-row activation and per-output-
    channel weight scales. x [..., K], w [O, K] (an nn.Linear's weight),
    b [O]; returns [..., O] in `out_dtype` (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    rows = x.reshape(-1, x.shape[-1])
    xq, xs = quantize_int8(rows, -1)                 # [M, K], [M, 1]
    wq, ws = quantize_int8(w, 1)                     # [O, K], [O, 1]
    acc = int_mm(xq, wq.t())                         # [M, O] int32
    y = _dequant(acc.float() * xs, ws.t(), b, out_dtype)
    return y.reshape(*x.shape[:-1], w.shape[0])


def _static_scale(a_amax):
    return _floor(a_amax) * _INV_127


def int8_dense_static(x, w, a_amax, b=None, out_dtype=None):
    """y = x @ w^T (+ b) with the calibrated per-channel activation absmax
    `a_amax` [K] (or a scalar) folded into w [O, K] before its per-output-
    channel quantization; returns [..., O] in `out_dtype` (default
    x.dtype)."""
    out_dtype = out_dtype or x.dtype
    a_scale = _static_scale(a_amax)                  # [K] or []
    rows = x.reshape(-1, x.shape[-1])
    xq = _codes(rows, a_scale)
    wq, ws = quantize_int8(w.float() * a_scale.reshape(1, -1), 1)
    acc = int_mm(xq, wq.t())
    return _dequant(acc.float(), ws.t(), b, out_dtype).reshape(
        *x.shape[:-1], w.shape[0])


def int8_expert_einsum(x, w, a_amax, out_dtype=None):
    """Per-expert y[e] = x[e] @ w[e] with the calibrated per-expert per-
    channel activation absmax a_amax [E, K] folded into each expert's
    weight: x [E, M, K], w [E, K, O] -> [E, M, O] in `out_dtype` (default
    x.dtype). One int8 product per expert."""
    out_dtype = out_dtype or x.dtype
    a_scale = _static_scale(a_amax)[:, None, :]      # [E, 1, K]
    xq = _codes(x, a_scale)
    wq, ws = quantize_int8(w.float() * a_scale.transpose(1, 2), 1)
    # each expert's [K, O] codes column-major: the TN layout of the int8
    # GEMM on the card
    wq_t = wq.transpose(1, 2).contiguous()           # [E, O, K]
    acc = torch.stack([int_mm(xq[e], wq_t[e].t())
                       for e in range(x.shape[0])])  # [E, M, O]
    return _dequant(acc.float(), ws, None, out_dtype)


def rows_amax(x):
    """fp32 per-channel absmax of x over every axis but the last: a
    calibration statistic."""
    return x.abs().float().amax(dim=tuple(range(x.dim() - 1)))


def record_amax(module, name: str, stat) -> None:
    """Raise the calibration buffer `name` of `module` to the elementwise
    max of itself and `stat` (an empty buffer takes `stat`)."""
    buf = getattr(module, name)
    setattr(module, name, stat if buf.numel() == 0 else
            torch.maximum(buf, stat))


def calibrated(module, name: str):
    """The calibrated scale buffer `name` of `module`; raises if no
    calibration filled it."""
    buf = getattr(module, name)
    if buf.numel() == 0:
        raise ValueError(
            f"{type(module).__name__}.{name} holds no calibrated scale: "
            "int8_static needs calibration (serve.calibrate_quant_scales, "
            "models/transfer.py::load_quant_scales)")
    return buf


# The attention out-projection's int8_static switch (process-wide, opt-in,
# read by models/blocks.py at each forward).
_ATTN_OUT_QUANT = os.environ.get("WM_QUANT_ATTN_OUT", "0") != "0"


def set_attn_out_quant(enabled: bool) -> None:
    """Opt-in: extend int8_static quantization to the attention
    out-projection (both the calibration statistics and the serving
    matmul)."""
    global _ATTN_OUT_QUANT
    _ATTN_OUT_QUANT = bool(enabled)


def attn_out_quant_enabled() -> bool:
    return _ATTN_OUT_QUANT
