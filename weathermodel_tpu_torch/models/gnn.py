"""GNN-RNN yield baseline, GraphSAGE over the county graph (port of
weathermodel_tpu/models/gnn.py; reference
`src/crop_yield/models/gnnrnn_yield_model.py`).

The county graph (a few hundred to a few thousand nodes) is a dense
row-normalized adjacency, and a layer's mean aggregation is one matmul
`adj_norm @ h`: full-graph training, no neighbour sampling.

* GNNCNNEncoder: weather [N, 6, 52] through convs 6 -> 64 -> 128 -> 256 ->
  512 (kernels 9/3/3/3, no padding), each followed by ReLU and AvgPool/2
  (lengths 52 -> 44 -> 22 -> 20 -> 10 -> 8 -> 4 -> 2 -> 1), then
  Linear(512, 80) + ReLU; soil [N, 11, 6] as 11 channels of length 6
  through 11 -> 16 -> 32 -> 64 (kernels 3/3/2, no pooling: 6 -> 4 -> 2 ->
  1), then Linear(64, 40) + ReLU; concatenated, 120 features.
* node features: the 120 + [c, c^2, 0.5 c, y_past_i] of the normalized
  coordinates c = (lat / 360, lng / 180): 127.
* n_layers SAGEConv(mean): h' = fc_self(h) + fc_neigh(adj_norm @ h); ReLU
  and dropout after every layer, the last one too (the reference's quirk,
  kept by the JAX package).
* an LSTM(z_dim) over the years (flax's `OptimizedLSTMCell` with a zero
  carry, as `models/cnn.py`'s: `bias_ih_l0` zero and not trained), then
  Linear(z_dim, z_dim / 2) + ReLU + Linear(z_dim / 2, 1) on the last year.

The neighbours are the counties +-2 places away in the sorted county order,
not in geography (`build_county_adjacency`). The model computes in fp32 and
takes no model config, as the JAX module does. The inits are the JAX
package's (models/cnn.py's conv and LSTM inits, torch_dense's for every
Linear), drawn from the `reset_parameters` generator;
`models/transfer.py::gnn_state_dict_from_jax_params` carries JAX parameters
across.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from weathermodel_tpu_torch.models.blocks import torch_linear_init_
from weathermodel_tpu_torch.models.cnn import flax_lstm_init_
from weathermodel_tpu_torch.ops.dropout import draw_seed, rand_dropout
from weathermodel_tpu_torch.ops.normalize import normalize_year_interval_coords

WEEKS = 52
CNN_FEATURES = 120
# [c, c^2, 0.5 c, y_past_i] of the two normalized coordinates
EXTRA_FEATURES = 7


def build_county_adjacency(n_counties: int) -> np.ndarray:
    """Row-normalized dense adjacency with self-loops and +-2-index
    neighbours (reference gnnrnn_dataloader.py:238-267)."""
    adj = np.zeros((n_counties, n_counties), dtype=np.float32)
    np.fill_diagonal(adj, 1.0)
    for i in range(n_counties):
        for j in range(max(0, i - 2), min(n_counties, i + 3)):
            if i != j:
                adj[i, j] = adj[j, i] = 1.0
    return adj / adj.sum(axis=1, keepdims=True)


class GNNCNNEncoder(nn.Module):
    """weather [M, 6, 52] + soil [M, 11, 6] -> [M, 120]."""

    def __init__(self):
        super().__init__()
        self.wconv1 = nn.Conv1d(6, 64, 9)
        self.wconv2 = nn.Conv1d(64, 128, 3)
        self.wconv3 = nn.Conv1d(128, 256, 3)
        self.wconv4 = nn.Conv1d(256, 512, 3)
        self.wfc = nn.Linear(512, 80)
        self.sconv1 = nn.Conv1d(11, 16, 3)
        self.sconv2 = nn.Conv1d(16, 32, 3)
        self.sconv3 = nn.Conv1d(32, 64, 2)
        self.sfc = nn.Linear(64, 40)

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        for layer in self.children():
            torch_linear_init_(layer.weight.flatten(1), layer.bias, generator)

    def forward(self, weather, soil):
        w = weather
        for conv in (self.wconv1, self.wconv2, self.wconv3, self.wconv4):
            w = F.avg_pool1d(torch.relu(conv(w)), 2)
        w = torch.relu(self.wfc(w.flatten(1)))
        s = soil
        for conv in (self.sconv1, self.sconv2, self.sconv3):
            s = torch.relu(conv(s))
        s = torch.relu(self.sfc(s.flatten(1)))
        return torch.cat([w, s], dim=1)


class SAGEConv(nn.Module):
    """Mean-aggregator GraphSAGE layer over the dense normalized
    adjacency."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc_self = nn.Linear(in_dim, out_dim)
        self.fc_neigh = nn.Linear(in_dim, out_dim)

    def forward(self, h, adj_norm):
        return self.fc_self(h) + self.fc_neigh(torch.matmul(adj_norm, h))


class GNNRNNYieldModel(nn.Module):
    """Full-graph forward, one target year's graph: weather [N, Y, 6, 52],
    soil [N, Y, 11, 6], coords [N, 2] (raw), y_past [N, Y], adj_norm [N, N]
    -> [N, 1]. In `train()` mode the dropout draws its seeds from the CPU
    `generator`; `dropout_rate` overrides the model's rate."""

    def __init__(self, n_past_years: int = 5, z_dim: int = 128,
                 n_layers: int = 3, dropout: float = 0.1):
        super().__init__()
        self.n_past_years, self.z_dim = n_past_years, z_dim
        self.dropout = dropout
        self.encoder = GNNCNNEncoder()
        self.sage = nn.ModuleList(
            SAGEConv(CNN_FEATURES + EXTRA_FEATURES if i == 0 else z_dim,
                     z_dim) for i in range(n_layers))
        self.lstm = nn.LSTM(z_dim, z_dim, batch_first=True)
        # flax's cell has one bias a gate (the hidden one)
        self.lstm.bias_ih_l0.requires_grad_(False)
        self.reg_fc1 = nn.Linear(z_dim, z_dim // 2)
        self.reg_fc2 = nn.Linear(z_dim // 2, 1)

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        self.encoder.reset_parameters(generator)
        for layer in self.sage:
            for fc in (layer.fc_self, layer.fc_neigh):
                torch_linear_init_(fc.weight, fc.bias, generator)
        flax_lstm_init_(self.lstm, generator)
        for fc in (self.reg_fc1, self.reg_fc2):
            torch_linear_init_(fc.weight, fc.bias, generator)

    def forward(self, weather, soil, coords, y_past, adj_norm,
                generator=None, dropout_rate=None):
        n, n_years = weather.shape[:2]
        rate = 0.0
        if self.training:
            rate = self.dropout if dropout_rate is None else dropout_rate
        if rate > 0.0 and generator is None:
            raise ValueError("training with dropout needs a generator (a "
                             "CPU torch.Generator for the dropout seeds)")
        _, _, coords_n = normalize_year_interval_coords(
            weather.new_zeros(n, 1), weather.new_ones(n, 1), coords)
        # the years folded into the conv batch, then unfolded; torch's
        # convs are NCL, so soil's 11 measurements are the channels and its
        # 6 depths the length, as flax's NLC transpose makes them
        cnn = self.encoder(weather.reshape(n * n_years, 6, WEEKS),
                           soil.reshape(n * n_years, 11, 6)).reshape(
                               n, n_years, CNN_FEATURES)
        hs = []
        for i in range(n_years):
            extra = torch.cat([coords_n, coords_n ** 2, coords_n * 0.5,
                               y_past[:, i:i + 1]], dim=1)        # [N, 7]
            h = torch.cat([cnn[:, i], extra], dim=1)              # [N, 127]
            for layer in self.sage:
                h = torch.relu(layer(h, adj_norm))
                if rate > 0.0:
                    h = rand_dropout(h, rate, draw_seed(generator))
            hs.append(h)
        out, _ = self.lstm(torch.stack(hs, dim=1))                # [N, Y, z]
        return self.reg_fc2(torch.relu(self.reg_fc1(out[:, -1])))
