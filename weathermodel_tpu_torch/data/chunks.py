"""On-disk chunk store for the NASA POWER pretraining tensors (a copy of
weathermodel_tpu/data/chunks.py:26-108,193-213, numpy only).

Per chunk id and frequency, an `.npz` with
  weather [N, 365, 31] float32 (z-scored), coords [N, 2] (lat, lon),
  index   [N, 2] = (temporal segment index, interval days per step),
the logical schema of the reference's chunks (nasa_power/dataloader.py:
103-107). The JAX package's native C++ reader is not ported (ROADMAP.md
queue A item 15); `load_chunk` reads with numpy.

`synthetic_chunk` is the JAX package's deterministic generator (seasonal
sinusoids + AR(1) noise, so masked reconstruction is learnable).
`write_synthetic_dataset` seeds each frequency with a fixed integer, where
the JAX package uses `hash(freq)`, which Python randomizes per process:
the same call writes the same bytes in every process.
"""

import os
from typing import Tuple

import numpy as np

from weathermodel_tpu_torch.utils.constants import (
    DATA_DIR,
    MAX_CONTEXT_LENGTH,
    TOTAL_WEATHER_VARS,
)

FREQ_INTERVALS = {"daily": 1, "weekly": 7, "monthly": 30}


def chunk_path(data_dir: str, freq: str, chunk_id: int) -> str:
    return os.path.join(
        data_dir, "processed", f"weather_dataset_{freq}_{chunk_id}.npz"
    )


def save_chunk(path: str, weather: np.ndarray, coords: np.ndarray,
               index: np.ndarray) -> None:
    if weather.ndim != 3 or coords.shape[1] != 2 or index.shape[1] != 2:
        raise ValueError(
            f"chunk arrays must be weather [N, T, F], coords [N, 2], index "
            f"[N, 2]; got {weather.shape}, {coords.shape}, {index.shape}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, weather=weather.astype(np.float32),
             coords=coords.astype(np.float32),
             index=index.astype(np.float32))


def load_chunk(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    with np.load(path) as z:
        return z["weather"], z["coords"], z["index"]


def synthetic_chunk(
    seed: int,
    n_samples: int = 64,
    seq_len: int = MAX_CONTEXT_LENGTH,
    n_features: int = TOTAL_WEATHER_VARS,
    freq: str = "weekly",
    n_segments: int = 3,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Learnable synthetic weather: per-feature annual sinusoid (random
    amplitude/phase per location) + AR(1) noise, z-scored per feature.
    index[:, 0] is a temporal segment index in [0, n_segments), so the
    cutoff year drops the later windows, as in the real ETL."""
    rng = np.random.default_rng(seed)
    interval = FREQ_INTERVALS[freq]
    day = np.arange(seq_len, dtype=np.float32) * interval
    amp = rng.uniform(0.5, 2.0, size=(n_samples, 1, n_features))
    phase = rng.uniform(0, 2 * np.pi, size=(n_samples, 1, n_features))
    seasonal = amp * np.sin(2 * np.pi * day[None, :, None] / 365.0 + phase)
    noise = rng.normal(size=(n_samples, seq_len, n_features)).astype(np.float32)
    for i in range(1, seq_len):
        noise[:, i] = 0.7 * noise[:, i - 1] + 0.3 * noise[:, i]
    weather = (seasonal + 0.5 * noise).astype(np.float32)
    weather = (weather - weather.mean(axis=(0, 1))) / (
        weather.std(axis=(0, 1)) + 1e-8
    )
    coords = np.stack(
        [rng.uniform(-55, 60, n_samples), rng.uniform(-170, 170, n_samples)],
        axis=1,
    ).astype(np.float32)
    segment = rng.integers(0, n_segments, size=n_samples)
    index = np.stack(
        [segment, np.full(n_samples, interval)], axis=1
    ).astype(np.float32)
    return weather, coords, index


def write_synthetic_dataset(
    data_dir: str = DATA_DIR,
    n_chunks: int = 8,
    n_samples: int = 64,
    seq_len: int = MAX_CONTEXT_LENGTH,
    freqs: Tuple[str, ...] = ("weekly",),
    seed: int = 0,
) -> None:
    """Write chunks 0..n_chunks-1 of every frequency in the chunk-store
    layout. Chunk `cid` of `freq` is seeded with
    seed + 131*cid + 1000*interval(freq)."""
    for freq in freqs:
        for cid in range(n_chunks):
            w, c, i = synthetic_chunk(
                seed + cid * 131 + 1000 * FREQ_INTERVALS[freq], n_samples,
                seq_len, freq=freq)
            save_chunk(chunk_path(data_dir, freq, cid), w, c, i)
