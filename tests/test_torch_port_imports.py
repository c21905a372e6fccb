"""The PyTorch port imports no JAX, and its size table, training defaults
and dataset constants are the JAX package's."""

import dataclasses
import subprocess
import sys
from pathlib import Path

from weathermodel_tpu.utils import config as jax_config
from weathermodel_tpu.utils import constants as jax_constants
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.utils import config as port_config
from weathermodel_tpu_torch.utils import constants as port_constants

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    modules = sorted(
        ".".join(path.relative_to(ROOT).with_suffix("").parts)
        for path in (ROOT / "weathermodel_tpu_torch").rglob("*.py")
        if path.name != "__init__.py")
    assert {"weathermodel_tpu_torch.train.trainer",
            "weathermodel_tpu_torch.bench",
            "weathermodel_tpu_torch.ops.fused_ffn",
            "weathermodel_tpu_torch.ops.fused_ffn_ln",
            "weathermodel_tpu_torch.ops.maskgen",
            "weathermodel_tpu_torch.ops.kernel_dropout",
            "weathermodel_tpu_torch.serving_daemon"} <= set(modules)
    code = (
        "import sys\n"
        "import chip_smoke\n"
        + "".join(f"import {m}\n" for m in modules) +
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'weathermodel_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr


def test_size_table_matches_jax_package():
    assert port_config.MODEL_SIZES == jax_config.MODEL_SIZES
    assert port_config.TOTAL_WEATHER_VARS == jax_constants.TOTAL_WEATHER_VARS
    assert port_config.MAX_CONTEXT_LENGTH == jax_constants.MAX_CONTEXT_LENGTH
    jax_fields = {f.name: f.default
                  for f in dataclasses.fields(jax_config.ModelConfig)}
    for f in dataclasses.fields(port_config.ModelConfig):
        assert f.default == jax_fields[f.name], f.name
    for size in port_config.MODEL_SIZES:
        a = port_config.model_config_for_size(size)
        b = jax_config.model_config_for_size(size)
        assert (a.hidden_dim, a.ffn_dim, a.input_dim, a.num_layers) == \
            (b.hidden_dim, b.ffn_dim, b.input_dim, b.num_layers)
    assert dataclasses.asdict(port_config.TrainConfig()) == \
        dataclasses.asdict(jax_config.TrainConfig())
    cfg = port_config.TrainConfig()
    for epoch in range(0, 80, 3):
        for base in (1, 10):
            assert port_config.n_masked_features_for_epoch(cfg, epoch, base) \
                == jax_config.n_masked_features_for_epoch(
                    jax_config.TrainConfig(), epoch, base)


def test_constants_match_jax_package():
    for name in ("VALIDATION_CHUNK_IDS", "DRY_RUN_TRAIN_CHUNK_IDS",
                 "NUM_DATASET_PARTS", "PRETRAIN_CUTOFF_YEAR", "DRY_RUN",
                 "DATA_DIR", "TOTAL_WEATHER_VARS", "MAX_CONTEXT_LENGTH"):
        assert getattr(port_constants, name) == \
            getattr(jax_constants, name), name
