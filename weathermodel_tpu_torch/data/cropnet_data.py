"""CropNet (WRF-HRRR weather + USDA yields) data pipeline: a copy of
weathermodel_tpu/data/cropnet_data.py (numpy and pandas only), so that the
port imports nothing of the JAX package.

Capability match for reference
`src/crop_yield/dataloader/cropnet_dataloader.py:17-414`:

* 8 weather variables x 52 weeks mapped into the 31-variable layout at
  indices CROPNET_FEATURE_INDICES = (0, 1, 2, 4, 7, 8, 23, 30);
* counties filtered to those with test-year yield (always test year 2021,
  k = 1 fold — reference weatherbert_yield_trainer.py:124-127);
* per-county forward-fill then station->county mean aggregation;
* yield z-scored over ALL years >= start_year (the reference's quirk —
  not train-only like the Khaki path); stats are RETURNED (replacing the
  CROP_SCALING_FACTORS mutable global, reference :14,333-339);
* zero practices/soil tensors (reference :227-228).

Outputs the same YieldArrays schema as yield_data so the trainers are
shared.
"""

import logging
import os
from typing import Tuple

import numpy as np
import pandas as pd

from weathermodel_tpu_torch.data.yield_data import YieldArrays, YieldStats
from weathermodel_tpu_torch.utils.constants import (
    CROPNET_FEATURE_INDICES,
    DATA_DIR,
    MAX_CONTEXT_LENGTH,
    TOTAL_WEATHER_VARS,
)

logger = logging.getLogger(__name__)

WEATHER_VARS = ("temp_avg", "temp_max", "temp_min", "precipitation",
                "humidity", "wind_speed", "radiation", "vpd")
WEEKS = 52
WEATHER_COLS = [f"{v}_{w}" for v in WEATHER_VARS for w in range(1, WEEKS + 1)]
CROPNET_TEST_YEAR = 2021
CROPNET_CROPS = ("Cotton", "Corn", "Soybeans", "WinterWheat")


def crop_yield_col(crop_type: str) -> str:
    # "WinterWheat" -> "winter wheat_yield" (reference :30)
    return f"{crop_type.lower().replace('winter', 'winter ')}_yield"


def read_cropnet_dataset(data_dir: str = DATA_DIR) -> pd.DataFrame:
    df = pd.read_csv(os.path.join(data_dir, "CropNet",
                                  "combined_cropnet_data.csv"))
    return df.sort_values(["fips", "year"])


def standardize_cropnet(
    cropnet_df: pd.DataFrame,
    crop_type: str,
    n_train_years: int,
    test_year: int,
) -> Tuple[pd.DataFrame, YieldStats]:
    """Reference split_train_test_by_year (:294-345): restrict to years >=
    start_year, ffill yields per county, z-score weather AND yield over the
    whole frame; returns explicit stats."""
    ycol = crop_yield_col(crop_type)
    start_year = test_year - n_train_years
    data = cropnet_df[cropnet_df["year"] >= start_year].copy()
    data = data.sort_values(["fips", "year"])
    data[ycol] = data.groupby("fips")[ycol].ffill()

    wcols = [c for c in WEATHER_COLS if c in data.columns]
    data[wcols] = (data[wcols] - data[wcols].mean()) / data[wcols].std()

    mean = float(data[ycol].mean())
    std = float(data[ycol].std())
    logger.info("CROP STATS - %s: mean=%.2f, std=%.2f", ycol, mean, std)
    data[ycol] = (data[ycol] - mean) / std
    data = data.fillna(0)
    return data, YieldStats(mean, std)


def build_cropnet_arrays(
    data: pd.DataFrame,
    crop_type: str,
    start_year: int,
    test_year: int,
    test_dataset: bool,
    n_past_years: int,
    test_gap: int = 0,
) -> YieldArrays:
    """Vectorized CropNetDataset construction (reference :17-268)."""
    ycol = crop_yield_col(crop_type)
    n_years = n_past_years + 1
    t_total = n_years * WEEKS
    if t_total > MAX_CONTEXT_LENGTH:
        raise ValueError(f"{t_total} > MAX_CONTEXT_LENGTH")

    # counties with test-year yield (reference STEP 1)
    test_rows = data[data["year"] == test_year]
    valid = test_rows[test_rows[ycol].notna()]["fips"].unique()
    data = data[data["fips"].isin(valid)].copy()
    logger.info("Filtered to %d counties with %s data for test year %d",
                len(valid), ycol, test_year)

    # forward fill (reference STEP 2); rebuilt via concat to keep the
    # frame defragmented (block-wise multi-column assignment warns + slows)
    data = data.sort_values(["fips", "year"])
    fill_cols = [ycol, "lat", "lon"] + [c for c in WEATHER_COLS
                                        if c in data.columns]
    filled = data.groupby("fips")[fill_cols].ffill()
    data = pd.concat([data.drop(columns=fill_cols), filled],
                     axis=1).copy()  # consolidate blocks

    # station -> county mean aggregation (reference STEP 3). Grouped
    # block-wise (one mean over all numeric columns + a first() for the
    # yield) instead of a per-column agg dict — same values, and pandas
    # doesn't rebuild the frame column by column (PerformanceWarning).
    g = data.groupby(["year", "fips"])
    mean_cols = ["lat", "lon"] + [c for c in WEATHER_COLS
                                  if c in data.columns]
    out = g[mean_cols].mean()
    out[ycol] = g[ycol].first()
    data = out.reset_index()
    data = data.sort_values(["fips", "year"]).reset_index(drop=True)

    pos = data.groupby("fips").cumcount().to_numpy()
    year_v = data["year"].to_numpy()
    if test_dataset:
        candidate = year_v == test_year
    else:
        candidate = (year_v >= start_year) & (year_v < test_year - test_gap)
    keep = candidate & (pos >= n_past_years)
    idx = np.flatnonzero(keep)
    n = len(idx)
    if n == 0:
        logger.warning("No samples found for %s dataset!",
                       "test" if test_dataset else "train")
        return YieldArrays(
            np.zeros((0, t_total, TOTAL_WEATHER_VARS), np.float32),
            np.zeros((0, 2), np.float32),
            np.zeros((0, t_total), np.float32),
            np.zeros((0, 1), np.float32),
            np.zeros((0, t_total, TOTAL_WEATHER_VARS), bool),
            np.zeros((0, n_years, 14), np.float32),
            np.zeros((0, n_years, 11, 6), np.float32),
            np.zeros((0, n_years), np.float32),
            np.zeros((0, 1), np.float32),
        )

    offsets = np.arange(-n_past_years, 1)
    rows = idx[:, None] + offsets[None, :]

    w_flat = data[WEATHER_COLS].to_numpy(np.float32)
    y_flat = data[ycol].to_numpy(np.float32)
    years_flat = data["year"].to_numpy(np.float32)
    coords_flat = data[["lat", "lon"]].to_numpy(np.float32)

    w = w_flat[rows].reshape(n, n_years, len(WEATHER_VARS), WEEKS)
    w = w.transpose(0, 1, 3, 2).reshape(n, t_total, len(WEATHER_VARS))
    padded = np.zeros((n, t_total, TOTAL_WEATHER_VARS), np.float32)
    padded[:, :, list(CROPNET_FEATURE_INDICES)] = w

    mask_row = np.ones(TOTAL_WEATHER_VARS, dtype=bool)
    mask_row[list(CROPNET_FEATURE_INDICES)] = False
    mask = np.broadcast_to(mask_row, (n, t_total, TOTAL_WEATHER_VARS)).copy()

    week_fr = np.arange(1, WEEKS + 1, dtype=np.float32) / WEEKS
    years = years_flat[rows]
    year_expanded = (years[:, :, None] + week_fr[None, None, :]
                     ).reshape(n, t_total)

    y_past = y_flat[rows].copy()
    # ffill/bfill residual NaNs then replace target year with previous
    # (reference :186-192)
    y_past = np.array(
        pd.DataFrame(y_past).ffill(axis=1).bfill(axis=1), dtype=np.float32
    )
    y = y_past[:, -1:].copy()
    y_past[:, -1] = y_past[:, -2]

    return YieldArrays(
        weather=padded,
        coords=coords_flat[idx],
        year=year_expanded,
        interval=np.full((n, 1), 7.0, np.float32),
        mask=mask,
        practices=np.zeros((n, n_years, 14), np.float32),
        soil=np.zeros((n, n_years, 11, 6), np.float32),
        y_past=y_past,
        y=y,
    )


def get_cropnet_train_test_arrays(
    cropnet_df: pd.DataFrame,
    crop_type: str,
    n_train_years: int,
    test_year: int = CROPNET_TEST_YEAR,
    n_past_years: int = 5,
) -> Tuple[YieldArrays, YieldArrays, YieldStats, int]:
    if n_train_years <= 1:
        raise ValueError(f"Not enough training data: {n_train_years}")
    if n_train_years < n_past_years + 1:
        logger.warning("Adjusting n_past_years from %d to %d",
                       n_past_years, n_train_years - 1)
        n_past_years = n_train_years - 1
    data, stats = standardize_cropnet(cropnet_df, crop_type, n_train_years,
                                      test_year)
    start_year = test_year - n_train_years
    train = build_cropnet_arrays(data, crop_type, start_year, test_year,
                                 False, n_past_years)
    test = build_cropnet_arrays(data, crop_type, start_year, test_year,
                                True, n_past_years)
    return train, test, stats, n_past_years


def synthetic_cropnet_df(seed: int = 0, n_counties: int = 8,
                         years: Tuple[int, int] = (2010, 2021),
                         stations_per_county: int = 2) -> pd.DataFrame:
    """Learnable synthetic CropNet frame (multiple stations per county to
    exercise the aggregation path)."""
    rng = np.random.default_rng(seed)
    rows = []
    county_effect = rng.normal(100, 15, n_counties)
    w_coef = rng.normal(0, 1.0, len(WEATHER_VARS))
    for ci in range(n_counties):
        fips = 10000 + ci
        lat, lon = rng.uniform(30, 45), rng.uniform(-100, -85)
        for yr in range(years[0], years[1] + 1):
            w_county = rng.normal(0, 1, (len(WEATHER_VARS), WEEKS))
            season = w_county[:, 16:40].mean(axis=1)
            base_yield = (county_effect[ci] + 10 * w_coef @ season
                          + rng.normal(0, 2))
            for s in range(stations_per_county):
                w = w_county + rng.normal(0, 0.1,
                                          w_county.shape)  # station noise
                row = {"fips": fips, "year": yr, "state": "SS",
                       "county": f"c{ci}",
                       "lat": lat + s * 0.01, "lon": lon + s * 0.01}
                for crop in CROPNET_CROPS:
                    row[crop_yield_col(crop)] = base_yield
                for vi, v in enumerate(WEATHER_VARS):
                    for wk in range(WEEKS):
                        row[f"{v}_{wk+1}"] = w[vi, wk]
                rows.append(row)
    return pd.DataFrame(rows).sort_values(["fips", "year"])
