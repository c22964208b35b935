"""The port's data layer (multistgraph_tpu_torch/data, config) against the JAX package.

Both packages read the same synthetic atomic files; windows, splits, scaler
statistics, adjacency, static features, coordinates and group stats must
agree. Floats are held to rtol=1e-12: pandas' C float parser and numpy's
may differ in the last bit; integers and strings must match exactly.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from multistgraph_tpu.config import load_config as jax_load_config
from multistgraph_tpu.data import get_dataset as jax_get_dataset
from multistgraph_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.data import atomic
from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset

FLOAT_RTOL = 1e-12


def _args(data_dir, cache_dir, **overrides):
    args = {
        "data_dir": data_dir, "cache_dir": cache_dir,
        "len_closeness": 2, "len_period": 1, "len_trend": 1,
        "interval_period": 2, "interval_trend": 5,
        "input_window": 24, "output_window": 6,
        "train_rate": 0.7, "eval_rate": 0.15,
        "load_external": True, "load_dynamic": False,
        "add_time_in_day": True, "add_day_in_week": False,
        "groupstd": True, "add_static": True, "batch_size": 4, "seed": 0,
    }
    args.update(overrides)
    return args


def _datasets(data_dir, tmp_path, **overrides):
    args = _args(data_dir, str(tmp_path / "cache"), **overrides)
    ours = get_dataset(load_config("traffic_state_pred", "MultiATGCN", "SYN_SMALL", other_args=args),
                       device="cpu")
    ref = jax_get_dataset(jax_load_config("traffic_state_pred", "MultiATGCN", "SYN_SMALL",
                                          other_args=args))
    return ours, ref


def test_config_matches_jax(synthetic_dataset, tmp_path):
    args = _args(synthetic_dataset, str(tmp_path), weight_stream_quant="int8")
    ours = load_config("traffic_state_pred", "MultiATGCN", "SYN_SMALL", other_args=args).to_dict()
    ref = jax_load_config("traffic_state_pred", "MultiATGCN", "SYN_SMALL", other_args=args).to_dict()
    assert ours == ref


@pytest.mark.parametrize("overrides", [
    {},
    {"add_day_in_week": True, "load_dynamic": True, "scaler": "minmax01"},
])
def test_windows_splits_and_features_match_jax(synthetic_dataset, tmp_path, overrides):
    ours, ref = _datasets(synthetic_dataset, tmp_path, **overrides)
    for a, b in zip(ours._load_or_generate_splits(), ref._load_or_generate_splits()):
        np.testing.assert_allclose(a, b, rtol=FLOAT_RTOL, atol=0)
    our_loaders, ref_loaders = ours.get_data(), ref.get_data()
    for ol, rl in zip(our_loaders, ref_loaders):
        assert isinstance(ol.x, torch.Tensor) and ol.x.device.type == "cpu"
        np.testing.assert_array_equal(ol.x.numpy(), np.asarray(rl.x))
        np.testing.assert_array_equal(ol.y.numpy(), np.asarray(rl.y))
        np.testing.assert_array_equal(ol.epoch_permutation(), rl.epoch_permutation())
    fo, fr = ours.get_data_feature(), ref.get_data_feature()
    assert set(fo) == set(fr)
    for key in ("ext_dim", "num_nodes", "feature_dim", "output_dim", "num_batches",
                "len_closeness", "len_period", "len_trend"):
        assert fo[key] == fr[key], key
    assert type(fo["scaler"]).__name__ == type(fr["scaler"]).__name__
    for field in ("mean", "std", "min", "max"):
        if hasattr(fr["scaler"], field):
            np.testing.assert_allclose(getattr(fo["scaler"], field), getattr(fr["scaler"], field),
                                       rtol=FLOAT_RTOL)
    np.testing.assert_allclose(fo["adj_mx"], fr["adj_mx"], rtol=FLOAT_RTOL)
    assert fo["adj_mx"].dtype == fr["adj_mx"].dtype
    np.testing.assert_allclose(fo["static"], fr["static"], rtol=FLOAT_RTOL)
    np.testing.assert_allclose(fo["node_profiles"], fr["node_profiles"], rtol=1e-6)
    for col in fr["coordinate"].columns:
        got, want = fo["coordinate"][col], fr["coordinate"][col].to_numpy()
        assert got.tolist() == want.tolist(), col
    for col in fr["ct_visit_mstd"].columns:
        want = fr["ct_visit_mstd"][col].to_numpy()
        if want.dtype.kind == "f":
            np.testing.assert_allclose(fo["ct_visit_mstd"][col], want, rtol=FLOAT_RTOL)
        else:
            np.testing.assert_array_equal(fo["ct_visit_mstd"][col], want)


def test_cache_files_do_not_collide(synthetic_dataset, tmp_path):
    ours, ref = _datasets(synthetic_dataset, tmp_path, cache_dataset=True)
    ours.get_data()
    ref.get_data()
    assert ours.cache_file_name != ref.cache_file_name
    assert os.path.exists(ours.cache_file_name) and os.path.exists(ref.cache_file_name)
    cached, _ = _datasets(synthetic_dataset, tmp_path, cache_dataset=True)
    for a, b in zip(cached._load_or_generate_splits(), ours._load_or_generate_splits()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kwargs", [
    {"num_nodes": 6, "len_time": 24 * 36, "seed": 3},
    {"num_nodes": 5, "len_time": 24 * 36, "seed": 11, "groupstd_normalize": False,
     "node_stats": "DC237"},
])
def test_generator_writes_the_jax_files(tmp_path, kwargs):
    if kwargs.get("node_stats") == "DC237":
        import multistgraph_tpu

        kwargs = dict(kwargs, node_stats=os.path.join(
            os.path.dirname(multistgraph_tpu.__file__), "data", "stats", "DC237_visit_mstd.csv"))
    make_synthetic_dataset(str(tmp_path / "port"), "SYN", **kwargs)
    jax_make_synthetic(str(tmp_path / "jax"), "SYN", **kwargs)
    names = sorted(os.listdir(tmp_path / "jax" / "SYN"))
    assert names == sorted(os.listdir(tmp_path / "port" / "SYN"))
    for name in names:
        assert filecmp.cmp(tmp_path / "jax" / "SYN" / name, tmp_path / "port" / "SYN" / name,
                           shallow=False), name


def test_jax_dataset_reads_port_files_as_its_own(tmp_path):
    make_synthetic_dataset(str(tmp_path / "port"), "SYN_SMALL", num_nodes=8, len_time=24 * 40, seed=5)
    jax_make_synthetic(str(tmp_path / "jax"), "SYN_SMALL", num_nodes=8, len_time=24 * 40, seed=5)
    splits = []
    for root in ("port", "jax"):
        args = _args(str(tmp_path / root), str(tmp_path / ("cache_" + root)), cache_dataset=False)
        ds = jax_get_dataset(jax_load_config("traffic_state_pred", "MultiATGCN", "SYN_SMALL",
                                             other_args=args))
        splits.append(ds._load_or_generate_splits())
    for a, b in zip(*splits):
        np.testing.assert_array_equal(a, b)


def test_csv_reader_types_and_missing_cells(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text('a,b,c,d\n1,2.5,x,"[1.0, 2.0]"\n3,,y,"[3.0, 4.0]"\n')
    cols = atomic.read_csv(str(path))
    assert cols["a"].dtype == np.int64 and cols["a"].tolist() == [1, 3]
    assert cols["b"].dtype == np.float64 and np.isnan(cols["b"][1])
    assert atomic.isna(cols["b"]).tolist() == [False, True]
    assert cols["c"].tolist() == ["x", "y"]
    assert cols["d"].tolist() == ["[1.0, 2.0]", "[3.0, 4.0]"]
