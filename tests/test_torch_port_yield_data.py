"""The port's yield data pipeline against the JAX package's: the synthetic
Khaki and CropNet frames, the standardized frames and their stats, the
train and test arrays (test_gap 0 and 4, the n_past_years clamp, the
DRY_RUN cut), the padded batches, CropNet's station aggregation and the
readers, all bitwise equal."""

import json

import numpy as np
import pandas as pd
import pytest

from weathermodel_tpu.data import cropnet_data as jax_cropnet
from weathermodel_tpu.data import yield_data as jax_yield
from weathermodel_tpu_torch.data import cropnet_data, yield_data
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401


def _equal_arrays(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def frames():
    port = yield_data.synthetic_yield_df(seed=3, n_locs=6)
    jax = jax_yield.synthetic_yield_df(seed=3, n_locs=6)
    return port, jax


def test_synthetic_frames_are_the_jax_frames(frames):
    pd.testing.assert_frame_equal(*frames)
    pd.testing.assert_frame_equal(
        cropnet_data.synthetic_cropnet_df(seed=2, n_counties=3),
        jax_cropnet.synthetic_cropnet_df(seed=2, n_counties=3))


def test_standardized_frame_and_stats(frames):
    port, jax = frames
    got, got_stats = yield_data.standardize_and_split(port, 8, 2016,
                                                      "soybean", "usa")
    want, want_stats = jax_yield.standardize_and_split(jax, 8, 2016,
                                                       "soybean", "usa")
    pd.testing.assert_frame_equal(got, want)
    assert tuple(got_stats) == tuple(want_stats)


@pytest.mark.parametrize("n_train_years,n_past,test_gap", [
    (8, 2, 0), (8, 2, 4), (3, 6, 0), (15, 6, 0)])
def test_train_test_arrays(frames, n_train_years, n_past, test_gap):
    port, jax = frames
    got = yield_data.get_train_test_arrays(port, n_train_years, 2017, n_past,
                                           "soybean", "usa", test_gap)
    want = jax_yield.get_train_test_arrays(jax, n_train_years, 2017, n_past,
                                           "soybean", "usa", test_gap)
    _equal_arrays(got[0], want[0])   # train
    _equal_arrays(got[1], want[1])   # test
    assert tuple(got[2]) == tuple(want[2]) and got[3] == want[3]
    assert got[0].weather.shape[0] > 0 and got[1].weather.shape[0] > 0
    assert got[0].weather.shape[1] == (got[3] + 1) * 52


@pytest.mark.parametrize("test_dataset", [False, True])
def test_dry_run_cut_and_empty_sets(frames, test_dataset):
    port, jax = frames
    data, _ = yield_data.standardize_and_split(port, 8, 2016, "soybean",
                                               "usa")
    for dry_run in (True, False):
        _equal_arrays(
            yield_data.build_yield_arrays(data, 2008, 2016, test_dataset, 2,
                                          "soybean", dry_run=dry_run),
            jax_yield.build_yield_arrays(data, 2008, 2016, test_dataset, 2,
                                         "soybean", dry_run=dry_run))
    # a test year with no rows gives the empty arrays of the same shapes
    _equal_arrays(
        yield_data.build_yield_arrays(data, 2030, 2040, test_dataset, 2,
                                      "soybean"),
        jax_yield.build_yield_arrays(data, 2030, 2040, test_dataset, 2,
                                     "soybean"))


@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_shuffle_and_pad_as_jax(frames, shuffle):
    port, _ = frames
    train, _, _, _ = yield_data.get_train_test_arrays(port, 8, 2017, 2,
                                                      "soybean", "usa")
    got = list(yield_data.yield_batches(train, 7, shuffle, seed=5))
    want = list(jax_yield.yield_batches(train, 7, shuffle, seed=5))
    assert len(got) == len(want) == -(-train.weather.shape[0] // 7)
    for (a, wa), (b, wb) in zip(got, want):
        _equal_arrays(a, b)
        np.testing.assert_array_equal(wa, wb)
    # the last batch repeats its last index at weight 0
    last, w = got[-1]
    pad = int((w == 0).sum())
    assert pad == 7 * len(got) - train.weather.shape[0]
    if pad:
        np.testing.assert_array_equal(last.y[-pad:],
                                      np.repeat(last.y[-pad - 1:-pad], pad,
                                                axis=0))


@pytest.mark.parametrize("crop", ["Corn", "WinterWheat"])
def test_cropnet_arrays_with_station_aggregation(crop):
    df = cropnet_data.synthetic_cropnet_df(seed=1, n_counties=4,
                                           stations_per_county=3)
    assert df.groupby(["fips", "year"]).size().eq(3).all()
    got = cropnet_data.get_cropnet_train_test_arrays(df, crop, 6)
    want = jax_cropnet.get_cropnet_train_test_arrays(df, crop, 6)
    _equal_arrays(got[0], want[0])
    _equal_arrays(got[1], want[1])
    assert tuple(got[2]) == tuple(want[2]) and got[3] == want[3]
    # one window per county and year: the stations were averaged
    assert got[1].weather.shape[0] == 4
    assert cropnet_data.crop_yield_col(crop) == jax_cropnet.crop_yield_col(
        crop)


def test_readers_and_non_usa_scalers(tmp_path, frames):
    port, _ = frames
    root = tmp_path / "khaki_soybeans"
    root.mkdir()
    shuffled = port.sample(frac=1.0, random_state=0)
    shuffled.to_csv(root / "khaki_multi_crop_yield.csv", index=False)
    brazil = shuffled.assign(State=np.where(shuffled["loc_ID"] % 2 == 0,
                                            "Paraná", "Bahia"))
    brazil.to_csv(root / "khaki_brazil_multi_crop.csv", index=False)
    scalers = {f"week_{w}": {
        "param_means": {p: 0.1 * w + i for i, p in
                        enumerate(yield_data.PARAM_TO_INDEX)},
        "param_stds": {p: (0.0 if (w, i) == (3, 2) else 1.0 + 0.01 * w)
                       for i, p in enumerate(yield_data.PARAM_TO_INDEX)}}
        for w in range(1, 53)}
    scalers["meta"] = {}
    with open(root / "weekly_weather_param_scalers.json", "w") as f:
        json.dump(scalers, f)
    d = str(tmp_path)
    pd.testing.assert_frame_equal(yield_data.read_usa_dataset(d),
                                  jax_yield.read_usa_dataset(d))
    got = yield_data.read_non_us_dataset(d, "brazil")
    pd.testing.assert_frame_equal(got,
                                  jax_yield.read_non_us_dataset(d, "brazil"))
    assert set(got["State"]) == {"Paraná"}
    path = str(root / "weekly_weather_param_scalers.json")
    assert yield_data.load_weather_scalers(path) == \
        jax_yield.load_weather_scalers(path)
    pd.testing.assert_frame_equal(
        yield_data.standardize_weather_cols(got, "brazil", d),
        jax_yield.standardize_weather_cols(got, "brazil", d))
