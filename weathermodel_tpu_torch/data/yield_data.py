"""Crop-yield data pipeline (Khaki county-level datasets): a copy of
weathermodel_tpu/data/yield_data.py, numpy and pandas only, so that the port
imports nothing of the JAX package. `tests/test_torch_port_yield_data.py`
holds its arrays, batches and stats bitwise equal to the JAX module's.

Capability match for reference `src/crop_yield/dataloader/yield_dataloader.py`,
redesigned as the JAX package's:

* the reference's O(N^2) per-row `has_sufficient_history` apply
  (:170-183) becomes a vectorized groupby-rank;
* per-fold yield mean/std are RETURNED (YieldStats) instead of appended to
  the CROP_YIELD_STATS mutable global (:388-389);
* samples are materialized as batched numpy arrays, padded to a fixed batch
  size with a sample-weight vector (one shape for every step) instead of a
  torch DataLoader with a ragged final batch.

Tensor layout preserved exactly (reference :200-296): weather weeks for the
6 observed variables scattered into a zero [T, 31] at indices
[7, 8, 11, 1, 2, 29]; static feature mask True = the 25 missing features;
year + (week+1)/52 fractions; y_past with the target year's value replaced
by the previous year's; interval = 7.
"""

import json
import os
from typing import Dict, Iterator, NamedTuple, Tuple

import numpy as np
import pandas as pd

from weathermodel_tpu_torch.utils.constants import (
    DATA_DIR,
    DRY_RUN,
    MAX_CONTEXT_LENGTH,
    TOTAL_WEATHER_VARS,
    YIELD_FEATURE_INDICES,
)

WEATHER_COLS = [f"W_{i}_{j}" for i in range(1, 7) for j in range(1, 53)]
PRACTICE_COLS = [f"P_{i}" for i in range(1, 15)]
SOIL_MEASUREMENTS = ["bdod", "cec", "cfvo", "clay", "nitrogen", "ocd",
                     "ocs", "phh2o", "sand", "silt", "soc"]
SOIL_DEPTHS = ["0-5cm", "5-15cm", "15-30cm", "30-60cm", "60-100cm",
               "100-200cm"]
SOIL_COLS = [f"{m}_mean_{d}" for m in SOIL_MEASUREMENTS for d in SOIL_DEPTHS]

# JSON scaler parameter names -> weather variable index
# (reference yield_dataloader.py:28-35)
PARAM_TO_INDEX = {
    "T2M_MAX": 1, "T2M_MIN": 2, "PRECTOTCORR": 7,
    "ALLSKY_SFC_SW_DWN": 8, "SNODP": 11, "VAP": 29,
}

WEEKS = 52
N_OBSERVED = 6


class YieldStats(NamedTuple):
    """Per-fold target scaling (explicit replacement for the reference's
    CROP_YIELD_STATS global)."""

    mean: float
    std: float


class YieldArrays(NamedTuple):
    weather: np.ndarray    # [N, T, 31]
    coords: np.ndarray     # [N, 2]
    year: np.ndarray       # [N, T]
    interval: np.ndarray   # [N, 1]
    mask: np.ndarray       # [N, T, 31] bool
    practices: np.ndarray  # [N, n_years, 14]
    soil: np.ndarray       # [N, n_years, 11, 6]
    y_past: np.ndarray     # [N, n_years]
    y: np.ndarray          # [N, 1]


def read_usa_dataset(data_dir: str = DATA_DIR) -> pd.DataFrame:
    df = pd.read_csv(os.path.join(data_dir, "khaki_soybeans",
                                  "khaki_multi_crop_yield.csv"))
    return df.sort_values(["loc_ID", "year"])


BRAZIL_STATES = ["Goiás", "Mato Grosso", "Mato Grosso do Sul", "Paraná",
                 "Rio Grande do Sul"]


def read_non_us_dataset(data_dir: str, country: str) -> pd.DataFrame:
    df = pd.read_csv(os.path.join(data_dir, "khaki_soybeans",
                                  f"khaki_{country}_multi_crop.csv"))
    if country == "brazil":
        df = df[df["State"].isin(BRAZIL_STATES)].copy()
    return df.sort_values(["loc_ID", "year"])


def load_weather_scalers(json_path: str) -> Dict[str, Dict[str, float]]:
    """weekly_weather_param_scalers.json -> {'W_i_j': {'mean','std'}}
    (reference :20-61)."""
    with open(json_path) as f:
        scaler_data = json.load(f)
    out = {}
    for week_key, week_data in scaler_data.items():
        if not week_key.startswith("week_"):
            continue
        week = int(week_key.split("_")[1])
        for param, idx in PARAM_TO_INDEX.items():
            if param in week_data.get("param_means", {}):
                out[f"W_{idx}_{week}"] = {
                    "mean": week_data["param_means"][param],
                    "std": week_data["param_stds"][param],
                }
    return out


def standardize_weather_cols(data: pd.DataFrame, country: str,
                             data_dir: str = DATA_DIR) -> pd.DataFrame:
    """USA: z-score from the dataset itself; non-USA: fixed USA-derived
    weekly scalers from JSON (reference :64-111)."""
    data = data.copy()
    cols = [c for c in WEATHER_COLS if c in data.columns]
    if country.lower() != "usa":
        json_path = os.path.join(data_dir, "khaki_soybeans",
                                 "weekly_weather_param_scalers.json")
        if not os.path.exists(json_path):
            raise FileNotFoundError(f"JSON scalers file not found at {json_path}")
        scalers = load_weather_scalers(json_path)
        for col in cols:
            if col in scalers:
                std = scalers[col]["std"]
                if std > 0:
                    data[col] = (data[col] - scalers[col]["mean"]) / std
                else:
                    data[col] = 0
    elif cols:
        means, stds = data[cols].mean(), data[cols].std()
        data[cols] = ((data[cols] - means) / stds).fillna(0)
    return data


def standardize_and_split(
    crop_df: pd.DataFrame,
    n_train_years: int,
    test_year: int,
    crop_type: str,
    country: str,
) -> Tuple[pd.DataFrame, YieldStats]:
    """Full standardization pass (reference split_train_test_by_year
    :314-411): weather, then soil/practices, then yield z-scored on
    TRAIN-year stats. Returns the standardized frame + explicit stats."""
    yield_col = f"{crop_type}_yield"
    start_year = test_year - n_train_years

    data = crop_df[crop_df["year"] > 1981.0].copy()
    data = data.dropna(subset=[yield_col])
    data = data.fillna(0)

    data = standardize_weather_cols(data, country)

    exclude = {"loc_ID", "year", "State", "County", "lat", "lng", yield_col}
    exclude.update(WEATHER_COLS)
    cols = [c for c in data.columns if c not in exclude
            and np.issubdtype(data[c].dtype, np.number)]
    if cols:
        data[cols] = ((data[cols] - data[cols].mean()) / data[cols].std())
        data[cols] = data[cols].fillna(0)

    train = data[(data["year"] >= start_year) & (data["year"] < test_year)]
    mean, std = float(train[yield_col].mean()), float(train[yield_col].std())
    data[yield_col] = (data[yield_col] - mean) / std
    return data, YieldStats(mean, std)


def build_yield_arrays(
    data: pd.DataFrame,
    start_year: int,
    test_year: int,
    test_dataset: bool,
    n_past_years: int,
    crop_type: str,
    test_gap: int = 0,
    dry_run: bool = DRY_RUN,
) -> YieldArrays:
    """Vectorized CropDataset construction (reference :114-296)."""
    yield_col = f"{crop_type}_yield"
    n_years = n_past_years + 1
    seq_len = WEEKS
    t_total = n_years * seq_len
    if t_total > MAX_CONTEXT_LENGTH:
        raise ValueError(
            f"n_years * seq_len = {t_total} is greater than "
            f"MAX_CONTEXT_LENGTH = {MAX_CONTEXT_LENGTH}"
        )
    start_year = start_year - test_gap

    d = data.sort_values(["loc_ID", "year"]).reset_index(drop=True)
    # position of each row within its location group
    pos = d.groupby("loc_ID").cumcount().to_numpy()

    year_v = d["year"].to_numpy()
    if test_dataset:
        candidate = year_v == test_year
    else:
        candidate = (year_v >= start_year) & (year_v < test_year - test_gap)
    # sufficient history: at least n_past_years earlier rows for this loc
    valid = candidate & (pos >= n_past_years)
    idx = np.flatnonzero(valid)
    if dry_run:
        idx = idx[: max(1, len(idx) // 20)]
    n = len(idx)
    if n == 0:
        return YieldArrays(
            *[np.zeros(s, dtype=np.float32) for s in [
                (0, t_total, TOTAL_WEATHER_VARS), (0, 2), (0, t_total),
                (0, 1)]],
            np.zeros((0, t_total, TOTAL_WEATHER_VARS), dtype=bool),
            np.zeros((0, n_years, 14), dtype=np.float32),
            np.zeros((0, n_years, 11, 6), dtype=np.float32),
            np.zeros((0, n_years), dtype=np.float32),
            np.zeros((0, 1), dtype=np.float32),
        )

    # gather [N, n_years] row indices: consecutive positions ending at idx
    offsets = np.arange(-n_past_years, 1)
    rows = idx[:, None] + offsets[None, :]          # [N, n_years]

    weather_flat = d[WEATHER_COLS].to_numpy(dtype=np.float32)
    practices_flat = d[PRACTICE_COLS].to_numpy(dtype=np.float32)
    soil_flat = d[SOIL_COLS].to_numpy(dtype=np.float32)
    yields_flat = d[yield_col].to_numpy(dtype=np.float32)
    years_flat = d["year"].to_numpy(dtype=np.float32)
    coords_flat = d[["lat", "lng"]].to_numpy(dtype=np.float32)

    # weather: [N, n_years, 6, 52] -> [N, n_years*52, 6]
    w = weather_flat[rows].reshape(n, n_years, N_OBSERVED, WEEKS)
    w = w.transpose(0, 1, 3, 2).reshape(n, t_total, N_OBSERVED)
    padded = np.zeros((n, t_total, TOTAL_WEATHER_VARS), dtype=np.float32)
    padded[:, :, list(YIELD_FEATURE_INDICES)] = w

    mask_row = np.ones(TOTAL_WEATHER_VARS, dtype=bool)
    mask_row[list(YIELD_FEATURE_INDICES)] = False
    mask = np.broadcast_to(mask_row, (n, t_total, TOTAL_WEATHER_VARS)).copy()

    week_fractions = (np.arange(1, WEEKS + 1, dtype=np.float32) / WEEKS)
    years = years_flat[rows]                        # [N, n_years]
    year_expanded = (years[:, :, None] + week_fractions[None, None, :]
                     ).reshape(n, t_total)

    y = yields_flat[rows][:, -1:].copy()            # [N, 1]
    y_past = yields_flat[rows].copy()               # [N, n_years]
    y_past[:, -1] = y_past[:, -2]                   # target year -> previous

    return YieldArrays(
        weather=padded,
        coords=coords_flat[idx],
        year=year_expanded,
        interval=np.full((n, 1), 7.0, dtype=np.float32),
        mask=mask,
        practices=practices_flat[rows].reshape(n, n_years, 14),
        soil=soil_flat[rows].reshape(n, n_years, 11, 6),
        y_past=y_past,
        y=y,
    )


def get_train_test_arrays(
    crop_df: pd.DataFrame,
    n_train_years: int,
    test_year: int,
    n_past_years: int,
    crop_type: str,
    country: str,
    test_gap: int = 0,
) -> Tuple[YieldArrays, YieldArrays, YieldStats, int]:
    """Split + standardize + tensorize (reference get_train_test_loaders
    :441-492). Returns (train, test, yield_stats, effective_n_past_years)."""
    if n_train_years <= 1:
        raise ValueError(
            f"Not enough training data: n_train_years={n_train_years}"
        )
    if n_train_years < n_past_years + 1:
        n_past_years = n_train_years - 1

    data, stats = standardize_and_split(
        crop_df, n_train_years, test_year, crop_type, country
    )
    start_year = test_year - n_train_years
    train = build_yield_arrays(data, start_year, test_year, False,
                               n_past_years, crop_type, test_gap)
    test = build_yield_arrays(data, start_year, test_year, True,
                              n_past_years, crop_type, test_gap)
    return train, test, stats, n_past_years


def yield_batches(arrays: YieldArrays, batch_size: int, shuffle: bool,
                  seed: int = 0) -> Iterator[Tuple[YieldArrays, np.ndarray]]:
    """Fixed-size batches with zero-padding + sample weights (1 = real,
    0 = padding) so every batch has a static shape."""
    n = arrays.weather.shape[0]
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for i in range(0, n, batch_size):
        sel = order[i:i + batch_size]
        pad = batch_size - len(sel)
        weights = np.concatenate(
            [np.ones(len(sel), np.float32), np.zeros(pad, np.float32)]
        )
        sel_padded = np.concatenate([sel, np.repeat(sel[-1:], pad)])
        yield (YieldArrays(*[a[sel_padded] for a in arrays]), weights)


# ---------------------------------------------------------------------------
# Synthetic yield data (tests / benchmarks / DRY-RUN equivalent)
# ---------------------------------------------------------------------------

def synthetic_yield_df(
    seed: int = 0,
    n_locs: int = 12,
    years: Tuple[int, int] = (2000, 2019),
    crop_type: str = "soybean",
) -> pd.DataFrame:
    """Learnable synthetic Khaki-format frame: yield depends linearly on
    mean growing-season weather + location effect + slow trend + noise."""
    rng = np.random.default_rng(seed)
    rows = []
    loc_effect = rng.normal(30, 5, n_locs)
    lat = rng.uniform(30, 48, n_locs)
    lng = rng.uniform(-120, -80, n_locs)
    soil_vals = rng.normal(0, 1, (n_locs, len(SOIL_COLS)))
    w_coef = rng.normal(0, 1.0, N_OBSERVED)
    for li in range(n_locs):
        for yr in range(years[0], years[1] + 1):
            w = rng.normal(0, 1, (N_OBSERVED, WEEKS)).astype(np.float32)
            w += np.sin(np.arange(WEEKS) / WEEKS * 2 * np.pi)[None, :]
            season_mean = w[:, 16:40].mean(axis=1)
            y = (loc_effect[li] + 5.0 * w_coef @ season_mean
                 + 0.3 * (yr - years[0]) + rng.normal(0, 1.5))
            row = {"loc_ID": li, "year": yr, "lat": lat[li], "lng": lng[li],
                   "State": "SynthState", "County": f"c{li}",
                   f"{crop_type}_yield": y}
            for i in range(N_OBSERVED):
                for j in range(WEEKS):
                    row[f"W_{i+1}_{j+1}"] = w[i, j]
            for p in range(14):
                row[f"P_{p+1}"] = rng.normal()
            for ci, c in enumerate(SOIL_COLS):
                row[c] = soil_vals[li, ci]
            rows.append(row)
    return pd.DataFrame(rows).sort_values(["loc_ID", "year"])
