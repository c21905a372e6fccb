"""The port's three masking policies: the statistics tests/test_masking.py
holds the JAX package's to, on masks drawn from a torch.Generator, with
n_masked passed as a tensor."""

import numpy as np
import pytest
import torch

from weathermodel_tpu_torch.ops.masking import (
    bert_mask,
    feature_mask,
    make_mask,
    segment_mask,
)

B, T, F = 64, 365, 31


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_bert_mask_rate():
    m = bert_mask(_gen(0), B, T, F, 0.15, "cpu")
    assert m.shape == (B, T, F) and m.dtype == torch.bool
    assert abs(m.float().mean().item() - 0.15) < 0.01


@pytest.mark.parametrize("n", [1, 5, 25])
def test_feature_mask_exact_count_and_uniformity(n):
    m = feature_mask(_gen(1), B, T, F, torch.tensor(n), "cpu")
    assert m.shape == (B, T, F)
    # exactly n whole features per sample, constant across time
    assert (m[:, 0, :].sum(-1) == n).all()
    assert torch.equal(m, m[:, :1, :].expand(B, T, F))
    if n == 5:  # tests/test_masking.py's uniformity check, at its n
        counts = m[:, 0, :].sum(0).float()
        assert counts.std() / counts.mean() < 0.5


def test_segment_mask_target_and_structure():
    prob = 0.15
    m = segment_mask(_gen(3), B, T, F, prob, "cpu")
    target = int(T * prob)
    assert torch.equal(m, m[:, :, :1].expand(B, T, F))
    counts = m[:, :, 0].sum(-1).numpy()
    # trimmed to exactly `target` wherever more were drawn; the reference
    # algorithm (and the JAX package's) only trims excess, so a few fall
    # short, as tests/test_masking.py allows
    assert (counts <= target).all()
    assert (counts == target).mean() > 0.4
    assert abs(counts.mean() - target) / target < 0.15
    pos = m[:, :, 0].numpy()
    run_starts = (pos[:, 1:] & ~pos[:, :-1]).sum() + pos[:, 0].sum()
    assert 2.0 < pos.sum() / max(run_starts, 1) < 8.0
    assert not segment_mask(_gen(0), 4, 10, 3, 0.05, "cpu").any()


def test_make_mask_dispatch_and_reproducibility():
    for name in ("weatherbert", "weatherformer", "simmtm"):
        m = make_mask(name, _gen(4), 4, 20, F, device="cpu", prob=0.2,
                      n_masked=torch.tensor(2))
        assert m.shape == (4, 20, F)
        assert torch.equal(m, make_mask(name, _gen(4), 4, 20, F,
                                        device="cpu", prob=0.2,
                                        n_masked=torch.tensor(2)))
    with pytest.raises(ValueError):
        make_mask("nope", _gen(4), 4, 20, F, device="cpu")
    # the curriculum changes n_masked without changing any shape
    shapes = {make_mask("weatherformer", _gen(5), 4, 20, F, device="cpu",
                        n_masked=torch.tensor(n)).shape for n in (1, 3, 25)}
    assert shapes == {(4, 20, F)}
    assert np.isclose(
        make_mask("weatherformer", _gen(5), 8, 20, F, device="cpu",
                  n_masked=torch.tensor(3))[:, 0].sum().item(), 24)
