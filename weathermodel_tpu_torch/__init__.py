"""weathermodel_tpu_torch — the PyTorch/CUDA port of weathermodel_tpu for
NVIDIA Hopper GPUs.

It mirrors the JAX package's module names, so each module has its
counterpart under `weathermodel_tpu/`. The JAX package is the reference the
port is tested against; this package imports torch and numpy, never JAX.

Ported so far: the offline serving path of WeatherBERT (`cli/serve.py`),
with the fused QKV-projection attention as a hand-written CUDA kernel
(`csrc/fused_qkv_attention.cu`).
"""

__version__ = "0.1.0"
