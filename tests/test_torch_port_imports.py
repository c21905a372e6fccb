"""The PyTorch port imports no JAX, and its size table, training defaults
and dataset constants are the JAX package's; an exported bundle loads
without the port's model code."""

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
            "weathermodel_tpu_torch.ops.headpack",
            "weathermodel_tpu_torch.ops.blocked_mm",
            "weathermodel_tpu_torch.scripts.abl_headpack",
            "weathermodel_tpu_torch.scripts.abl_gemm_probe",
            "weathermodel_tpu_torch.serving_daemon",
            "weathermodel_tpu_torch.data.yield_data",
            "weathermodel_tpu_torch.data.cropnet_data",
            "weathermodel_tpu_torch.models.yield_models",
            "weathermodel_tpu_torch.train.yield_trainer",
            "weathermodel_tpu_torch.train.lr_finder",
            "weathermodel_tpu_torch.train.checkpoint",
            "weathermodel_tpu_torch.models.mlp",
            "weathermodel_tpu_torch.ops.quant",
            "weathermodel_tpu_torch.cli.yield_main",
            "weathermodel_tpu_torch.cli.cropnet_main",
            "weathermodel_tpu_torch.cli.grid_search",
            "weathermodel_tpu_torch.cli.best_config",
            "weathermodel_tpu_torch.parallel.mesh",
            "weathermodel_tpu_torch.parallel.multihost",
            "weathermodel_tpu_torch.parallel.step_check",
            "weathermodel_tpu_torch.export_artifact",
            "weathermodel_tpu_torch.cli.export",
            "weathermodel_tpu_torch.models.cnn",
            "weathermodel_tpu_torch.models.gnn",
            "weathermodel_tpu_torch.data.gnnrnn_data",
            "weathermodel_tpu_torch.train.gnn_trainer",
            "weathermodel_tpu_torch.models.chronos_bolt",
            "weathermodel_tpu_torch.models.chronos"} <= set(modules)
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
                 "DATA_DIR", "TOTAL_WEATHER_VARS", "MAX_CONTEXT_LENGTH",
                 "CROPS", "YIELD_FEATURE_INDICES",
                 "CROPNET_FEATURE_INDICES"):
        assert getattr(port_constants, name) == \
            getattr(jax_constants, name), name


# what loading a bundle may import of the port: the loader, and for a
# program that holds wm::gmm the module that registers it (and the kernel
# build module that it imports)
BUNDLE_LOADER = {"weathermodel_tpu_torch",
                 "weathermodel_tpu_torch.export_artifact"}
GMM_OP = {"weathermodel_tpu_torch.ops", "weathermodel_tpu_torch.ops.gmm",
          "weathermodel_tpu_torch.kernels",
          "weathermodel_tpu_torch.kernels.build"}


def test_bundles_load_without_the_port_model_code(tmp_path):
    """A subprocess serves a dense bundle through ExportedPredictor with
    nothing of the port imported but the loader, and a MoE bundle with the
    op's module besides; neither imports JAX."""
    import torch

    from weathermodel_tpu_torch.cli.pretrain import make_model
    from weathermodel_tpu_torch.export_artifact import write_bundle

    for name, experts in (("dense", 0), ("moe", 4)):
        cfg = port_config.model_config_for_size(
            "mini", max_len=8, num_experts=experts, compute_dtype="float32")
        model = make_model("weatherbert", cfg, "torch")
        model.reset_parameters(torch.Generator().manual_seed(0))
        write_bundle(str(tmp_path / f"{name}.wmx"), model, None, (2,), 8,
                     platforms=("cpu",))
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from weathermodel_tpu_torch.export_artifact import "
        "ExportedPredictor\n"
        "for path in sys.argv[1:]:\n"
        "    out = ExportedPredictor(path)(\n"
        "        np.ones((3, 8, 31), np.float32),\n"
        "        np.zeros((3, 2), np.float32),\n"
        "        np.full((3, 8), 1990.0, np.float32),\n"
        "        np.full((3, 1), 7.0, np.float32),\n"
        "        np.zeros((3, 8, 31), bool))\n"
        "    assert out.shape == (3, 8, 31) and np.isfinite(out).all()\n"
        "    print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('weathermodel_tpu_torch', 'weathermodel_tpu', 'jax', 'flax')))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "dense.wmx"),
         str(tmp_path / "moe.wmx")],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    dense, moe = (set(eval(line))
                  for line in proc.stdout.strip().splitlines()[-2:])
    assert dense == BUNDLE_LOADER, dense ^ BUNDLE_LOADER
    assert moe == BUNDLE_LOADER | GMM_OP, moe ^ (BUNDLE_LOADER | GMM_OP)
