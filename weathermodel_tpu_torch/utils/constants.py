"""Dataset-wide constants (a copy of weathermodel_tpu/utils/constants.py:
16-50, reference constants.py:8-55), so that the port imports nothing of
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

# Crops supported by the yield pipeline (reference constants.py:19-48 keys).
CROPS = ("soybean", "corn", "wheat", "sunflower", "cotton", "sugarcane", "beans")

# Indices (within the 31-variable layout) of the 6 weather features present
# in the Khaki crop-yield datasets (reference yield_dataloader.py:157).
YIELD_FEATURE_INDICES = (7, 8, 11, 1, 2, 29)

# CropNet's 8 weather variables mapped into the 31-variable layout
# (reference cropnet_dataloader.py:48).
CROPNET_FEATURE_INDICES = (0, 1, 2, 4, 7, 8, 23, 30)
