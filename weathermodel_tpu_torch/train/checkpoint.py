"""What the trainer writes (port of weathermodel_tpu/train/checkpoint.py:
117-124 and the best-params save).

* `write_output_json` - the per-epoch experiment record
  `{workdir}/{name}_output.json` (reference base_trainer.py:475-489).
* `save_best_params` - the model's `state_dict()` as a reference-format
  `.pth` (`{workdir}/best.pth`), which `wm-serve-torch --checkpoint` and
  `--pretrained-model-path` load unchanged.

Full train-state checkpoints (optimizer moments, epoch, mid-epoch resume)
are not ported yet (ROADMAP.md queue A item 7; item 16 for the orbax
format).
"""

import json
import os

import torch

BEST_PARAMS = "best.pth"


def write_output_json(workdir: str, name: str, output_json: dict) -> str:
    path = os.path.join(workdir, f"{name}_output.json")
    os.makedirs(workdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(output_json, f, indent=2)
    return path


def save_best_params(workdir: str, model: torch.nn.Module) -> str:
    """Write the model's parameters (CPU copies) to `{workdir}/best.pth`,
    through a temporary file so a reader never sees a partial one."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, BEST_PARAMS)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path
