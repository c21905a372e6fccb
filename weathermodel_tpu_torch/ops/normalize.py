"""Input normalization for temporal/spatial conditioning features
(port of weathermodel_tpu/ops/normalize.py, reference utils.py:63-74):
year -> (year - 1970) / 100, interval -> interval / 30,
lat -> lat / 360, lon -> lon / 180."""

import torch


def normalize_year_interval_coords(year, interval, coords):
    year = (year - 1970.0) / 100.0
    interval = interval / 30.0
    coords = torch.stack([coords[..., 0] / 360.0, coords[..., 1] / 180.0],
                         dim=-1)
    return year, interval, coords
