"""The PyTorch port imports no JAX, and its size table is the JAX package's."""

import dataclasses
import subprocess
import sys
from pathlib import Path

from weathermodel_tpu.utils import config as jax_config
from weathermodel_tpu.utils import constants as jax_constants
from weathermodel_tpu_torch.utils import config as port_config


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import weathermodel_tpu_torch.cli.pretrain\n"
        "import weathermodel_tpu_torch.cli.serve\n"
        "import weathermodel_tpu_torch.serve\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'weathermodel_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
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
