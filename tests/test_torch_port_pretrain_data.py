"""The port's chunk store and pretraining loader against the JAX package's:
one store written once with the JAX package's `save_chunk`, read by both
loaders; and the port's synthetic writer, which must give the same arrays
in every process (the JAX one seeds with the per-process `hash(freq)`)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from weathermodel_tpu.data import chunks as jax_chunks
from weathermodel_tpu.data import pretraining as jax_pretraining
from weathermodel_tpu_torch.data import chunks as port_chunks
from weathermodel_tpu_torch.data import pretraining as port_pretraining
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401

T = 24
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """Train chunks 0-3 and validation chunk 7 (VALIDATION_CHUNK_IDS), 30
    windows each, weekly; about a third reach the cutoff year."""
    root = tmp_path_factory.mktemp("store")
    for cid in (0, 1, 2, 3, 7):
        w, c, i = jax_chunks.synthetic_chunk(100 + cid, 30, T, freq="weekly")
        jax_chunks.save_chunk(jax_chunks.chunk_path(str(root), "weekly", cid),
                              w, c, i)
    return str(root)


def _batches(module, store, split, shuffle, seed):
    cfg = module.PretrainDataConfig(data_dir=store, batch_size=8,
                                    dry_run=False)
    return list(module.pretrain_batches(split, cfg, shuffle=shuffle,
                                        seed=seed))


@pytest.mark.parametrize("split,shuffle,seed", [
    ("train", True, 1234), ("train", True, 7), ("train", False, 0),
    ("validation", False, 1234 + 100003)])
def test_loaders_give_the_same_batches(store, split, shuffle, seed):
    want = _batches(jax_pretraining, store, split, shuffle, seed)
    got = _batches(port_pretraining, store, split, shuffle, seed)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g._fields == w._fields
        for name, a, b in zip(g._fields, g, w):
            if b is None:
                assert a is None, name
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b), name
    if split == "validation":
        # the remainder is zero-padded with weight 0
        assert got[-1].weight is not None and got[-1].weight.min() == 0.0


def test_derived_years_and_split_ids():
    idx = np.array([0.0, 2.0], np.float32)
    itv = np.array([7.0, 1.0], np.float32)
    np.testing.assert_array_equal(
        port_pretraining.derive_years(idx, itv, T),
        jax_pretraining.derive_years(idx, itv, T))
    for dry_run in (False, True):
        for split in ("train", "validation"):
            for hosts, host in ((1, 0), (4, 3)):
                a = port_pretraining.split_chunk_ids(
                    split, port_pretraining.PretrainDataConfig(
                        dry_run=dry_run), hosts, host)
                b = jax_pretraining.split_chunk_ids(
                    split, jax_pretraining.PretrainDataConfig(
                        dry_run=dry_run), hosts, host)
                assert a == b


def test_synthetic_chunk_is_the_jax_generator():
    for a, b in zip(port_chunks.synthetic_chunk(5, 12, T, freq="daily"),
                    jax_chunks.synthetic_chunk(5, 12, T, freq="daily")):
        assert a.dtype == b.dtype and np.array_equal(a, b)


_WRITE = """
import sys
import numpy as np
from weathermodel_tpu_torch.data.chunks import chunk_path, write_synthetic_dataset
write_synthetic_dataset(sys.argv[1], n_chunks=2, n_samples=6, seq_len=12,
                        freqs=("daily", "weekly"), seed=3)
for f in ("daily", "weekly"):
    for c in range(2):
        with np.load(chunk_path(sys.argv[1], f, c)) as z:
            for k in sorted(z.files):
                sys.stdout.write(f"{f} {c} {k} {z[k].dtype} {z[k].shape} "
                                 f"{z[k].tobytes().hex()}\\n")
"""


def test_synthetic_dataset_is_the_same_in_every_process(tmp_path):
    outs = []
    for i, hash_seed in enumerate(("1", "2")):
        proc = subprocess.run(
            [sys.executable, "-c", _WRITE, str(tmp_path / str(i))],
            capture_output=True, text=True, timeout=120, cwd=REPO,
            env={"PYTHONHASHSEED": hash_seed, "PATH": "/usr/bin:/bin",
                 "PYTHONPATH": str(REPO)})
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout)
    assert outs[0] == outs[1] and outs[0].count("\n") == 12
