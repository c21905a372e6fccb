"""CNN model family, the Khaki-style baselines (port of
weathermodel_tpu/models/cnn.py).

* WeatherCNN (cnn.py:56): each (year, feature) 52-week series goes through a
  one-channel conv pyramid 1 -> 8 -> 12 -> 16 -> 20 channels (kernels
  9/3/3/3, no padding, AvgPool/2 after each), giving 20 features a series;
  per year a Linear(20 F -> output_dim) + ReLU. The (B, years, F) series
  are folded into one conv batch.
* WeatherCNNPretrain (cnn.py:95): masked-MSE pretraining with that encoder
  (the JAX package's working redesign of the reference's broken standalone
  CNN trainer): masked cells zeroed, T zero-padded up to whole 52-week
  years, the encoder with output_dim = weather_dim, then a per-year linear
  decoder back to that year's [52, F] block, cropped to T.
* SoilCNN (cnn.py:133): conv 1 -> 4 -> 8 -> 12 over the 6 soil depths of
  each measurement (flax SAME padding for the two k = 3 convs, an explicit
  pad of 1 for the k = 2 conv), the [12, 2] output flattened channel-major
  (torch's Flatten order), Linear(24, 12) + ReLU per measurement, then
  Linear(11 * 12, 40) per year.
* CNNRNNYieldModel (cnn.py:155): weather CNN + soil CNN + normalized coords
  + the mean normalized year + y_past per year -> LSTM(64) over the years ->
  Linear(64, 1) on the last step.

These are stock `nn.Conv1d`, `F.avg_pool1d` and `nn.LSTM` layers (the JAX
package runs them outside Pallas; on the card the LSTM is cuDNN's), in
fp32 whatever the configured compute dtype, as the JAX modules compute in
their fp32 parameters' dtype. The LSTM is flax's `OptimizedLSTMCell` with
a zero initial carry: gates i, f, g, o in `nn.LSTM`'s order, the hidden
bias in `bias_hh_l0` and zeros in `bias_ih_l0`, which is not trained
(flax's input kernels have no bias).
`models/transfer.py::cnn_state_dict_from_jax_params` carries JAX
parameters across.

The inits are the JAX package's: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
every conv and linear weight and bias (fan_in = in_channels x kernel for a
conv), and flax's LSTM init (lecun-normal input kernels, orthogonal
recurrent kernels, zero biases), drawn from the `reset_parameters`
generator.
"""

import torch
import torch.nn.functional as F
from torch import nn

from weathermodel_tpu_torch.models.blocks import torch_linear_init_
from weathermodel_tpu_torch.ops.normalize import normalize_year_interval_coords

WEEKS = 52
# the soil frame: 11 measurements at 6 depths a year
SOIL_MEASUREMENTS, SOIL_DEPTHS = 11, 6


def _torch_init(layers, generator) -> None:
    for layer in layers:
        torch_linear_init_(layer.weight.flatten(1), layer.bias, generator)


def lecun_normal_(weight, generator=None) -> None:
    """flax's lecun_normal: a normal truncated at 2 sigma, its std rescaled
    to sqrt(1 / fan_in) (fan_in = weight.shape[1], torch's [out, in])."""
    std = (1.0 / weight.shape[1]) ** 0.5 / .87962566103423978
    nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
    weight.mul_(std)


def flax_lstm_init_(lstm: nn.LSTM, generator=None) -> None:
    """flax's LSTM init on a one-layer nn.LSTM: lecun_normal input kernels,
    orthogonal recurrent kernels, a gate at a time, zero biases."""
    h = lstm.hidden_size
    with torch.no_grad():
        lecun_normal_(lstm.weight_ih_l0, generator)
        for gate in range(4):
            nn.init.orthogonal_(lstm.weight_hh_l0[gate * h:(gate + 1) * h],
                                generator=generator)
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()


class WeatherCNN(nn.Module):
    """[B, n_years * 52, F] -> [B, n_years, output_dim] per-year weather
    features (conv lengths 52 -> 44 -> 22 -> 20 -> 10 -> 8 -> 4 -> 2 -> 1).
    The layers do not depend on the number of years: `max_len` (n_years *
    52, JAX's field) only names the length the caller feeds."""

    CNN_FEATURES_PER_FEATURE = 20

    def __init__(self, weather_dim: int, output_dim: int, max_len: int):
        super().__init__()
        self.weather_dim, self.output_dim = weather_dim, output_dim
        self.max_len = max_len
        self.conv1 = nn.Conv1d(1, 8, 9)
        self.conv2 = nn.Conv1d(8, 12, 3)
        self.conv3 = nn.Conv1d(12, 16, 3)
        self.conv4 = nn.Conv1d(16, 20, 3)
        self.fc = nn.Linear(self.CNN_FEATURES_PER_FEATURE * weather_dim,
                            output_dim)

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        _torch_init((self.conv1, self.conv2, self.conv3, self.conv4,
                     self.fc), generator)

    def forward(self, weather, weather_feature_mask=None):
        b, t, f = weather.shape
        y = t // WEEKS
        if t != y * WEEKS:
            raise ValueError(f"WeatherCNN takes whole 52-week years, got "
                             f"T={t}")
        x = weather.float()
        if weather_feature_mask is not None:
            x = x * ~weather_feature_mask
        # [B, Y, W, F] -> one series a (year, feature): [B*Y*F, 1, W]
        x = x.reshape(b, y, WEEKS, f).permute(0, 1, 3, 2).reshape(
            b * y * f, 1, WEEKS)
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = F.avg_pool1d(torch.relu(conv(x)), 2)
        x = x.reshape(b * y, self.CNN_FEATURES_PER_FEATURE * f)
        return torch.relu(self.fc(x)).reshape(b, y, self.output_dim)


class WeatherCNNPretrain(nn.Module):
    """Masked-MSE pretraining model: [B, T, F] -> the [B, T, F]
    reconstruction (T zero-padded to whole years inside). `output_dim` 0
    is weather_dim (the reference's runtime value)."""

    def __init__(self, weather_dim: int, max_len: int, output_dim: int = 0):
        super().__init__()
        self.weather_dim, self.max_len = weather_dim, max_len
        out_dim = output_dim or weather_dim
        n_years = -(-max_len // WEEKS)
        self.cnn = WeatherCNN(weather_dim, out_dim, n_years * WEEKS)
        self.decoder = nn.Linear(out_dim, WEEKS * weather_dim)

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        self.cnn.reset_parameters(generator)
        _torch_init((self.decoder,), generator)

    def forward(self, weather, coords=None, year=None, interval=None,
                weather_feature_mask=None, generator=None,
                dropout_rate=None, return_moe_aux=False):
        """The generator and dropout rate the train step passes are
        ignored: the model has no dropout. Any T (JAX's too: `max_len` is
        not read)."""
        if return_moe_aux:
            raise ValueError("the CNN has no MoE layers")
        b, t, f = weather.shape
        n_years = -(-t // WEEKS)
        w = weather.float()
        if weather_feature_mask is not None:
            w = w * ~weather_feature_mask
        w = F.pad(w, (0, 0, 0, n_years * WEEKS - t))
        recon = self.decoder(self.cnn(w))
        return recon.reshape(b, n_years * WEEKS, f)[:, :t]


class SoilCNN(nn.Module):
    """soil [B, n_years, 11, 6] -> [B, n_years, 40]."""

    def __init__(self, n_measurements: int = SOIL_MEASUREMENTS):
        super().__init__()
        self.conv1 = nn.Conv1d(1, 4, 3, padding=1)   # flax SAME, k = 3
        self.conv2 = nn.Conv1d(4, 8, 3, padding=1)
        self.conv3 = nn.Conv1d(8, 12, 2, padding=1)  # explicit ((1, 1),)
        self.per_measure_fc = nn.Linear(24, 12)
        self.soil_fc = nn.Linear(n_measurements * 12, 40)

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        _torch_init((self.conv1, self.conv2, self.conv3,
                     self.per_measure_fc, self.soil_fc), generator)

    def forward(self, soil):
        b, y, n_meas, n_depths = soil.shape
        x = soil.float().reshape(b * y * n_meas, 1, n_depths)
        x = F.avg_pool1d(torch.relu(self.conv1(x)), 2)       # length 3
        x = F.avg_pool1d(torch.relu(self.conv2(x)), 2)       # length 1
        x = self.conv3(x).flatten(1)     # [N, 12, 2], channel-major: 24
        x = torch.relu(self.per_measure_fc(x))
        return self.soil_fc(x.reshape(b * y, n_meas * 12)).reshape(b, y, 40)


class CNNRNNYieldModel(nn.Module):
    """Khaki CNN-RNN baseline: [B, (n_past_years + 1) * 52, F] weekly
    weather (+ soil, y_past) -> [B, 1] yield. The keywords of the port's
    other yield models (generator, sample_generator, eps, dropout_rate)
    are taken and ignored: the model draws nothing."""

    def __init__(self, weather_dim: int, n_past_years: int,
                 output_dim: int = 60, soil_output_dim: int = 40,
                 lstm_hidden_dim: int = 64):
        super().__init__()
        self.weather_dim, self.n_past_years = weather_dim, n_past_years
        self.n_years = n_past_years + 1
        self.cnn = WeatherCNN(weather_dim, output_dim, self.n_years * WEEKS)
        self.soil_cnn = SoilCNN()
        self.lstm = nn.LSTM(output_dim + soil_output_dim + 4,
                            lstm_hidden_dim, batch_first=True)
        # flax's cell has one bias a gate (the hidden one): nn.LSTM's input
        # bias stays zero and out of training, or the gates' bias would
        # move at twice the rate
        self.lstm.bias_ih_l0.requires_grad_(False)
        self.output_layer = nn.Linear(lstm_hidden_dim, 1)

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        self.cnn.reset_parameters(generator)
        self.soil_cnn.reset_parameters(generator)
        flax_lstm_init_(self.lstm, generator)
        _torch_init((self.output_layer,), generator)

    def forward(self, weather, coords, year, interval, weather_feature_mask,
                y_past, soil=None, practices=None, generator=None,
                sample_generator=None, eps=None, dropout_rate=None):
        b = weather.shape[0]
        y = self.n_years
        if soil is None:
            soil = weather.new_zeros(b, y, SOIL_MEASUREMENTS, SOIL_DEPTHS)
        weather_features = self.cnn(weather, weather_feature_mask)
        soil_features = self.soil_cnn(soil)
        year_n, _, coords_n = normalize_year_interval_coords(
            year.float(), interval.float(), coords.float())
        year_mean = year_n.mean(dim=1, keepdim=True)          # [B, 1]
        lstm_in = torch.cat([
            weather_features, soil_features,
            coords_n[:, None, :].expand(b, y, 2),
            year_mean[:, :, None].expand(b, y, 1),
            y_past.float()[:, :, None]], dim=2)
        out, _ = self.lstm(lstm_in)                           # [B, Y, H]
        return self.output_layer(out[:, -1])
