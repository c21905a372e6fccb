"""GNN-RNN data, one full graph per target year (a copy of
weathermodel_tpu/data/gnnrnn_data.py; reference
`src/crop_yield/dataloader/gnnrnn_dataloader.py:128-524`; numpy and pandas
only).

Every target year becomes one graph-sized example: weather [N, n_years, 6,
52], soil [N, n_years, 11, 6], y_past [N, n_years], y [N] and valid [N].
Counties that lack a year of history or the yield are masked out of the
loss, not dropped, so the shapes stay the same from year to year. The
target year's y_past entry holds the year before's yield. The frame is
standardized as the Khaki pipeline does (`standardize_and_split`). Unlike
the other yield models' folds, the GNN's apply no `ahead_pred` test gap, as
in the JAX package.
"""

from typing import List, NamedTuple, Tuple

import numpy as np
import pandas as pd

from weathermodel_tpu_torch.data.yield_data import (
    SOIL_COLS,
    WEATHER_COLS,
    YieldStats,
    standardize_and_split,
)
from weathermodel_tpu_torch.models.gnn import build_county_adjacency

WEEKS = 52


class GNNArrays(NamedTuple):
    weather: np.ndarray   # [T_years, N, n_years, 6, 52]
    soil: np.ndarray      # [T_years, N, n_years, 11, 6]
    coords: np.ndarray    # [N, 2]
    y_past: np.ndarray    # [T_years, N, n_years]
    y: np.ndarray         # [T_years, N]
    valid: np.ndarray     # [T_years, N] bool
    target_years: np.ndarray  # [T_years]
    adj_norm: np.ndarray  # [N, N]


def build_gnn_arrays(
    data: pd.DataFrame,
    target_years: List[int],
    n_past_years: int,
    crop_type: str,
) -> GNNArrays:
    ycol = f"{crop_type}_yield"
    n_years = n_past_years + 1
    counties = np.sort(data["loc_ID"].unique())
    n = len(counties)
    cidx = {c: i for i, c in enumerate(counties)}

    years_all = np.sort(data["year"].unique())
    ymap = {y: i for i, y in enumerate(years_all)}
    n_all_years = len(years_all)

    # dense [N, n_all_years] grids, NaN where absent
    w_grid = np.full((n, n_all_years, 6, WEEKS), np.nan, np.float32)
    s_grid = np.full((n, n_all_years, 11, 6), np.nan, np.float32)
    y_grid = np.full((n, n_all_years), np.nan, np.float32)
    coords = np.zeros((n, 2), np.float32)

    w_cols = data[WEATHER_COLS].to_numpy(np.float32).reshape(-1, 6, WEEKS)
    s_cols = data[SOIL_COLS].to_numpy(np.float32).reshape(-1, 11, 6)
    y_col = data[ycol].to_numpy(np.float32)
    li = data["loc_ID"].map(cidx).to_numpy()
    yi = data["year"].map(ymap).to_numpy()
    w_grid[li, yi] = w_cols
    s_grid[li, yi] = s_cols
    y_grid[li, yi] = y_col
    lat = data.groupby("loc_ID")["lat"].first()
    lng = data.groupby("loc_ID")["lng"].first()
    coords[:, 0] = lat.reindex(counties).to_numpy(np.float32)
    coords[:, 1] = lng.reindex(counties).to_numpy(np.float32)

    t = len(target_years)
    weather = np.zeros((t, n, n_years, 6, WEEKS), np.float32)
    soil = np.zeros((t, n, n_years, 11, 6), np.float32)
    y_past = np.zeros((t, n, n_years), np.float32)
    y = np.zeros((t, n), np.float32)
    valid = np.zeros((t, n), bool)

    for ti, ty in enumerate(target_years):
        if ty not in ymap:
            continue
        end = ymap[ty]
        start = end - n_past_years
        if start < 0:
            continue
        sl = slice(start, end + 1)
        w_win = w_grid[:, sl]                  # [N, n_years, 6, 52]
        s_win = s_grid[:, sl]
        y_win = y_grid[:, sl].copy()           # [N, n_years]
        ok = (~np.isnan(y_win).any(axis=1)) & \
             (~np.isnan(w_win).any(axis=(1, 2, 3)))
        y[ti] = np.nan_to_num(y_win[:, -1])
        y_win[:, -1] = y_win[:, -2]            # target year -> previous
        weather[ti] = np.nan_to_num(w_win)
        soil[ti] = np.nan_to_num(s_win)
        y_past[ti] = np.nan_to_num(y_win)
        valid[ti] = ok

    return GNNArrays(weather, soil, coords, y_past, y, valid,
                     np.asarray(target_years), build_county_adjacency(n))


def get_gnn_train_test_arrays(
    crop_df: pd.DataFrame,
    n_train_years: int,
    test_year: int,
    n_past_years: int,
    crop_type: str,
    country: str,
) -> Tuple[GNNArrays, GNNArrays, YieldStats, int]:
    """(train arrays, test arrays, the train years' yield stats, the
    effective n_past_years: clamped to n_train_years - 1)."""
    if n_train_years < n_past_years + 1:
        n_past_years = n_train_years - 1
    data, stats = standardize_and_split(
        crop_df, n_train_years, test_year, crop_type, country)
    start_year = test_year - n_train_years
    train_years = [int(yr) for yr in range(start_year, test_year)]
    train = build_gnn_arrays(data, train_years, n_past_years, crop_type)
    test = build_gnn_arrays(data, [test_year], n_past_years, crop_type)
    return train, test, stats, n_past_years
