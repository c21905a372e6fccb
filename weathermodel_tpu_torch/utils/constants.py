"""Dataset-wide constants (a copy of weathermodel_tpu/utils/constants.py:
16-33, reference constants.py:8-55), so that the port imports nothing of
the JAX package. `tests/test_torch_port_imports.py` holds them equal."""

import os

# Root directory for on-disk datasets. Override with WEATHERMODEL_DATA_DIR.
DATA_DIR = os.environ.get("WEATHERMODEL_DATA_DIR", "data/")
DRY_RUN = os.environ.get("DRY_RUN", "False").lower() in ("true", "1", "t")

# NASA POWER dataset geometry (reference constants.py:50-55).
TOTAL_WEATHER_VARS = 31
MAX_CONTEXT_LENGTH = 365
NUM_DATASET_PARTS = 119
VALIDATION_CHUNK_IDS = (7, 30, 56, 59, 93, 106, 110, 24)
DRY_RUN_TRAIN_CHUNK_IDS = (1, 34, 53, 72, 81)

# Year at/after which pretraining samples are excluded (held out for
# downstream yield years; reference pretraining_dataloader.py:30,276-277).
PRETRAIN_CUTOFF_YEAR = 2002.0
