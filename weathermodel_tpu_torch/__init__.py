"""weathermodel_tpu_torch — the PyTorch/CUDA port of weathermodel_tpu for
NVIDIA Hopper GPUs.

It mirrors the JAX package's module names, so each module has its
counterpart under `weathermodel_tpu/`. The JAX package is the reference the
port is tested against; this package imports torch and numpy, never JAX.

Ported so far: the offline serving path of WeatherBERT (`cli/serve.py`,
`wm-serve-torch`) and its pretraining path (`cli/pretrain.py`,
`wm-pretrain-torch`: chunk loader, masking, masked-MSE step with gradient
accumulation, Adam, the epoch loop), with the fused QKV-projection attention
and its backward as hand-written CUDA kernels (`csrc/`).
"""

__version__ = "0.1.0"
