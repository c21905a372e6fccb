"""Mask generation for masked-reconstruction pretraining (port of
weathermodel_tpu/ops/masking.py, reference pretraining_dataloader.py:56-184).

Each policy draws its mask on `device` from the `torch.Generator` the caller
passes (a generator on that device), with static shapes:

* bert_mask    - iid Bernoulli(prob) per (timestep, feature)     ("weatherbert")
* feature_mask - exactly n whole features masked per sample        ("weatherformer")
* segment_mask - contiguous segments, geometric mean length 5,
                 trimmed to exactly floor(T*prob) positions,
                 the same mask across all features               ("simmtm")

`n_masked` may be a tensor (the masking curriculum changes it every 5
epochs); no shape depends on it.
"""

import torch

MEAN_SEGMENT_LENGTH = 5
MASKING_FUNCTIONS = ("weatherbert", "weatherformer", "simmtm")


def bert_mask(generator, batch_size, seq_len, n_features, prob, device):
    """True with probability `prob` at each (sample, timestep, feature)."""
    u = torch.rand(batch_size, seq_len, n_features, generator=generator,
                   device=device)
    return u < prob


def feature_mask(generator, batch_size, seq_len, n_features, n_masked,
                 device):
    """Exactly `n_masked` uniformly random whole features per sample,
    masked across all timesteps: the argsort of iid uniforms is a uniform
    random permutation, and its entries below n select n positions."""
    u = torch.rand(batch_size, n_features, generator=generator, device=device)
    perm = torch.argsort(u, dim=-1)
    n = torch.as_tensor(n_masked, device=device)
    per_feature = perm < n                                   # [B, F]
    return per_feature[:, None, :].expand(batch_size, seq_len, n_features)


def segment_mask(generator, batch_size, seq_len, n_features, prob, device):
    """Contiguous segments with geometric(mean=5) lengths, overlaps
    dropped, randomly trimmed to exactly floor(seq_len*prob) masked
    positions per sample where more were drawn, broadcast over features
    (the vectorized algorithm of the JAX package, masking.py:51-110)."""
    target = int(seq_len * prob)
    if target == 0:
        return torch.zeros(batch_size, seq_len, n_features, dtype=torch.bool,
                           device=device)
    n_seg = max(1, target // MEAN_SEGMENT_LENGTH + 5)

    def uniform(*shape):
        return torch.rand(*shape, generator=generator, device=device)

    # Geometric(mean=MEAN_SEGMENT_LENGTH) lengths: floor(log u / log(1-p)),
    # clamped to [1, seq_len]
    p = 1.0 / MEAN_SEGMENT_LENGTH
    u = uniform(batch_size, n_seg).clamp_(min=1e-12)
    lengths = torch.floor(torch.log(u) / torch.log1p(torch.tensor(-p)))
    lengths = lengths.to(torch.int64).clamp_(1, seq_len)

    # start uniformly in [0, seq_len - length] so lengths are never cut
    max_start = (seq_len - lengths).clamp_(min=0)
    starts = torch.floor(uniform(batch_size, n_seg)
                         * (max_start + 1).float()).to(torch.int64)

    # sort segments by start; drop any that overlaps its predecessor
    starts, order = torch.sort(starts, dim=-1, stable=True)
    lengths = torch.gather(lengths, -1, order)
    ends = starts + lengths
    prev_ends = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], -1)
    valid = starts >= prev_ends

    positions = torch.arange(seq_len, device=device)[None, None, :]
    within = ((positions >= starts[:, :, None])
              & (positions < ends[:, :, None]) & valid[:, :, None])
    pos_mask = within.any(dim=1)                             # [B, T]

    # trim to exactly `target`: random-rank the masked positions and keep
    # the `target` best-ranked ones
    rank_u = torch.where(pos_mask, uniform(batch_size, seq_len),
                         torch.tensor(float("inf"), device=device))
    ranks = torch.argsort(torch.argsort(rank_u, dim=-1, stable=True),
                          dim=-1, stable=True)
    needs_trim = pos_mask.sum(-1, keepdim=True) > target
    pos_mask = torch.where(needs_trim, ranks < target, pos_mask)
    return pos_mask[:, :, None].expand(batch_size, seq_len, n_features)


def make_mask(name, generator, batch_size, seq_len, n_features, *,
              device, prob=0.15, n_masked=1):
    """Dispatch by policy name (the reference loader's
    `masking_function`)."""
    if name == "weatherbert":
        return bert_mask(generator, batch_size, seq_len, n_features, prob,
                         device)
    if name == "weatherformer":
        return feature_mask(generator, batch_size, seq_len, n_features,
                            n_masked, device)
    if name == "simmtm":
        return segment_mask(generator, batch_size, seq_len, n_features, prob,
                            device)
    raise ValueError(f"Masking function {name} is not valid")
