"""The port's ablation scripts, each a port of one of the JAX package's
`scripts/`, run as `python -m weathermodel_tpu_torch.scripts.<name>`:

* `abl_headpack` - kernels P1 and P2, attention's matrix products per head
  and with three heads packed into block-diagonal operands;
* `abl_gemm_probe` - kernel P3, a hand-written blocked GEMM at the
  WeatherBERT-large FFN shape, against torch.matmul.

Each script runs on the card by default and exits without one unless given
`--device cpu`, which runs the kernels' plain versions. Its `main` returns
the numbers it prints; the command line sets only the device, and the
smaller runs (`main(device="cpu", batch=2)`) are `main`'s arguments. The
helpers below are theirs.
"""

import subprocess
import time

import torch


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or a note
    that the run is on the CPU."""
    if device.type != "cuda":
        return ("device: cpu (the kernels' plain versions; times are the "
                "CPU's)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return (f"device: {torch.cuda.get_device_name(device)} | nvidia-smi: "
            f"{smi[device.index or 0]} | torch {torch.__version__} cuda "
            f"{torch.version.cuda}")


def time_ms(fn, steps: int, device: torch.device) -> float:
    """ms per call of fn() over `steps` calls after one warm-up call: CUDA
    events on the card, a synchronised host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        return (time.perf_counter() - t0) / steps * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / steps
