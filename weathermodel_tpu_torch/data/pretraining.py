"""Pretraining batch pipeline: chunk files -> fixed-size numpy batches
(port of weathermodel_tpu/data/pretraining.py:44-175, reference
pretraining_dataloader.py:19-382).

The same chunk ids, years, cutoff filter and shuffles from the same seed
as the JAX package, so both loaders yield the same batches from one chunk
store:
  * train/validation chunk ids (fixed VALIDATION_CHUNK_IDS; DRY_RUN
    subset) with optional per-host contiguous slices,
  * per-timestep years year = 1984 + (chunk_idx*365 + t)*interval/365 and
    a filter dropping samples that reach the cutoff year,
  * chunk order and within-chunk order shuffled from the seed; the
    remainder carries over to the next chunk and is dropped at the epoch
    end for training, zero-padded with weight 0 for validation.

Batches are numpy; the trainer moves them to the device. Masks are drawn
in the train step, not here.
"""

import dataclasses
import logging
import os
import random
from typing import Iterator, List, Optional, Tuple

import numpy as np

from weathermodel_tpu_torch.data.chunks import chunk_path, load_chunk
from weathermodel_tpu_torch.train.steps import Batch
from weathermodel_tpu_torch.utils.constants import (
    DATA_DIR,
    DRY_RUN,
    DRY_RUN_TRAIN_CHUNK_IDS,
    NUM_DATASET_PARTS,
    PRETRAIN_CUTOFF_YEAR,
    VALIDATION_CHUNK_IDS,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class PretrainDataConfig:
    data_dir: str = DATA_DIR
    batch_size: int = 256
    freqs: Tuple[str, ...] = ("weekly",)
    cutoff_year: float = PRETRAIN_CUTOFF_YEAR
    num_parts: int = NUM_DATASET_PARTS
    dry_run: bool = DRY_RUN


def split_chunk_ids(split: str, cfg: PretrainDataConfig, num_hosts: int = 1,
                    host_id: int = 0) -> List[int]:
    """Train/validation chunk ids, optionally cut to this host's
    contiguous slice (reference :330-341)."""
    if cfg.dry_run:
        train = [i for i in DRY_RUN_TRAIN_CHUNK_IDS if i < cfg.num_parts]
        val = [i for i in VALIDATION_CHUNK_IDS[:4] if i < cfg.num_parts]
    else:
        train = sorted(
            set(range(cfg.num_parts)).difference(VALIDATION_CHUNK_IDS))
        val = [i for i in VALIDATION_CHUNK_IDS if i < cfg.num_parts]
    ids = train if split == "train" else val
    if num_hosts > 1:
        per_host = len(ids) // num_hosts
        ids = ids[host_id * per_host:(host_id + 1) * per_host]
    return ids


def derive_years(chunk_indices: np.ndarray, intervals: np.ndarray,
                 seq_len: int) -> np.ndarray:
    """year[n, t] = 1984 + (segment_idx*365 + t) * interval / 365
    (reference :250-256)."""
    t = np.arange(seq_len, dtype=np.float32)[None, :]
    abs_idx = chunk_indices[:, None] * 365.0 + t
    return 1984.0 + abs_idx * intervals[:, None] / 365.0


def _load_chunk_arrays(cfg: PretrainDataConfig, freq: str, chunk_id: int):
    w, c, idx = load_chunk(chunk_path(cfg.data_dir, freq, chunk_id))
    years = derive_years(idx[:, 0], idx[:, 1], w.shape[1])
    intervals = idx[:, 1:2]
    keep = years.max(axis=1) < cfg.cutoff_year
    return w[keep], c[keep], years[keep], intervals[keep]


def pretrain_batches(split: str, cfg: PretrainDataConfig,
                     shuffle: bool = False, seed: int = 0,
                     num_hosts: int = 1, host_id: int = 0) -> Iterator[Batch]:
    """Yields fixed-size numpy Batch tuples (no masks). Chunk order and
    within-chunk order are reshuffled per `seed` (pass epoch-dependent
    seeds)."""
    ids = split_chunk_ids(split, cfg, num_hosts, host_id)
    rng = random.Random(seed)
    npr = np.random.default_rng(seed)
    plan = [(freq, cid) for cid in ids for freq in cfg.freqs]
    # tolerate partially materialized chunk stores (subset downloads)
    missing = [(f, c) for f, c in plan
               if not os.path.exists(chunk_path(cfg.data_dir, f, c))]
    if missing:
        logger.warning("%d/%d %s chunks missing on disk (e.g. %s); skipping "
                       "them", len(missing), len(plan), split, missing[0])
        plan = [fc for fc in plan if fc not in set(missing)]
    if shuffle:
        rng.shuffle(plan)

    carry: Optional[List[np.ndarray]] = None
    bs = cfg.batch_size
    for freq, cid in plan:
        w, c, y, itv = _load_chunk_arrays(cfg, freq, cid)
        if w.shape[0] == 0:
            continue
        if shuffle:
            perm = npr.permutation(w.shape[0])
            w, c, y, itv = w[perm], c[perm], y[perm], itv[perm]
        if carry is not None:
            w, c, y, itv = (np.concatenate([a, b])
                            for a, b in zip(carry, (w, c, y, itv)))
            carry = None
        n_full = w.shape[0] // bs
        for i in range(n_full):
            sl = slice(i * bs, (i + 1) * bs)
            yield Batch(w[sl], c[sl], y[sl], itv[sl])
        rem = w.shape[0] - n_full * bs
        if rem:
            carry = [w[-rem:], c[-rem:], y[-rem:], itv[-rem:]]
    # Epoch-end remainder: training drops it; validation zero-pads it to
    # the batch size with weight 0 on the padding rows, so the validation
    # metric is exact for any validation-set size.
    if carry is not None and split != "train":
        n = carry[0].shape[0]
        pad = bs - n
        weight = np.concatenate([np.ones(n, np.float32),
                                 np.zeros(pad, np.float32)])
        logger.info("validation remainder of %d samples zero-padded "
                    "(weight 0) to the batch of %d", n, bs)
        yield Batch(*(np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                                  a.dtype)])
                      for a in carry), weight)
