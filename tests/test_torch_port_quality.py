"""The port's quality protocol (tools/quality_run.py, tools/aggregate_results.py,
written on csv and numpy) against the JAX tools, which are written on pandas
and imported by path, on the CPU.

  * ``_trans_frame`` on seeded predictions: every numeric column equal;
  * ``collect_trans_tables``, ``summarize`` and ``add_improvement`` on a
    tree of seeded ``*_trans.csv`` files (three models, one to three runs,
    a NaN metric): the same columns in the same order, the same rows,
    rtol 1e-12 (pandas sums a group's mean with compensation and its std
    by Welford's method, numpy pairwise: they part in the last bits), NaN
    where pandas has NaN; the written CSV has pandas' header;
  * the naive tables (persistence, seasonal) against JAX's
    ``_naive_trans_tables`` on one tiny synthetic dataset, each through
    its package's MTHDataset: rtol 1e-12;
  * ``quality_run.main`` end to end into a temporary root (8 nodes, 1
    epoch, seed 0, MultiATGCN and GRU): a row for every model x horizon
    and the naive rows, the margin sentence, a second run that skips every
    cached run and writes the same table, the carry-forward of a model
    whose run is gone; nothing written under the repository's docs/.
"""

import glob
import importlib.util
import os

import numpy as np
import pandas as pd
import pytest
import torch

from multistgraph_tpu.config import load_config as jax_load_config
from multistgraph_tpu.data import get_dataset as jax_get_dataset
from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset
from multistgraph_tpu_torch.executor.executor import TrafficStateExecutor
from multistgraph_tpu_torch.tools import aggregate_results, quality_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other CPU tests use beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location("jax_tool_" + name, os.path.join(REPO, "tools", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_quality():
    return _jax_tool("quality_run")


@pytest.fixture(scope="module")
def jax_aggregate():
    return _jax_tool("aggregate_results")


def _assert_frame_equal(ours, frame, rtol=RTOL):
    """A port column dict against a pandas frame: the same columns in the
    same order, strings equal, numbers within rtol, NaN where NaN."""
    assert list(ours) == list(frame.columns)
    for c in frame.columns:
        want = frame[c].to_numpy()
        if want.dtype == object:
            assert [str(v) for v in ours[c]] == [str(v) for v in want], c
        else:
            np.testing.assert_allclose(np.asarray(ours[c], np.float64), want.astype(np.float64), rtol=rtol,
                                       atol=0, err_msg=c)


def _mstd(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"geo_id": np.arange(n), "All_m": rng.uniform(5, 80, n), "All_std": rng.uniform(1, 40, n)}


def test_trans_frame_matches_jax(jax_quality):
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(40, 6, 7, 1)).astype(np.float32)
    truth = rng.normal(size=(40, 6, 7, 1)).astype(np.float32)
    mstd = _mstd(7)
    ours = quality_run._trans_frame(pred, truth, mstd, "GRU")
    want = jax_quality._trans_frame(pred, truth, pd.DataFrame(mstd), "GRU")
    assert list(ours) == list(want.columns) == quality_run.TRANS_COLUMNS
    assert list(ours["Model_name"]) == ["GRU"] * 6 and list(ours["index"]) == list(range(6))
    for c in ("index", "MAE", "MSE", "RMSE", "R2", "EVAR", "MAPE"):
        np.testing.assert_array_equal(np.asarray(ours[c], np.float64), want[c].to_numpy(np.float64), err_msg=c)


def _trans_tree(root):
    """Seeded *_trans.csv files: MultiATGCN 3 runs, GRU 2, DCRNN 1 (whose
    R2 is NaN at one step), 6 steps each, the executor's layout."""
    rng = np.random.default_rng(11)
    for model, runs in (("MultiATGCN", 3), ("GRU", 2), ("DCRNN", 1)):
        for run in range(runs):
            frame = {"Model_name": np.asarray([model] * 6, dtype=object), "index": np.arange(6),
                     "Model_time": np.asarray(["2026-01-01 00:00:00"] * 6, dtype=object)}
            for m in aggregate_results.METRICS:
                frame[m] = rng.uniform(1, 50, 6)
            if model == "DCRNN":
                frame["R2"][2] = np.nan
            cache = os.path.join(root, "q_{}_s{}".format(model, run), "evaluate_cache")
            os.makedirs(cache)
            aggregate_results.write_table(os.path.join(cache, "t_{}_trans.csv".format(model)), frame, index=True)


def test_summarize_and_improvement_match_pandas(tmp_path, jax_aggregate):
    root = str(tmp_path)
    _trans_tree(root)
    ours_table = aggregate_results.collect_trans_tables(root)
    want_table = jax_aggregate.collect_trans_tables(root)
    assert sorted(ours_table) == sorted(want_table.columns) and len(ours_table["run"]) == len(want_table) == 36
    horizons = [3, 6, 2]
    ours = aggregate_results.summarize(ours_table, horizons)
    want = jax_aggregate.summarize(want_table, horizons)
    _assert_frame_equal(ours, want)
    assert np.isnan(ours["MAE_std"][list(ours["Model_name"]).index("DCRNN")])   # one run: NaN, as pandas
    for reference in ("MultiATGCN", "GRU", "absent"):
        ours_ref = aggregate_results.add_improvement(ours, reference)
        want_ref = jax_aggregate.add_improvement(want, reference)
        _assert_frame_equal(ours_ref, want_ref)
    # the CSV: pandas' header, and pandas reads back the same numbers
    path = str(tmp_path / "summary.csv")
    aggregate_results.write_table(path, ours_ref)
    want_ref.to_csv(str(tmp_path / "want.csv"), index=False)
    with open(path) as f, open(str(tmp_path / "want.csv")) as g:
        assert f.readline() == g.readline()
    _assert_frame_equal(ours_ref, pd.read_csv(path))
    # the CLI, as JAX's
    printed = aggregate_results.main([root, "--horizons", "3", "6", "--reference", "GRU",
                                      "--out", str(tmp_path / "cli.csv")])
    _assert_frame_equal(printed, jax_aggregate.add_improvement(jax_aggregate.summarize(want_table, [3, 6]), "GRU"))


def _mth_args(raw, out):
    return {"data_dir": raw, "cache_dir": os.path.join(out, "cache"), "output_dir": out, "cache_dataset": False,
            "input_window": 24, "output_window": 24, "len_closeness": 2, "len_period": 1, "len_trend": 1,
            "interval_period": 1, "interval_trend": 2, "load_external": True, "load_dynamic": False,
            "add_time_in_day": True, "groupstd": True, "batch_size": 16, "train_rate": 0.7, "eval_rate": 0.15,
            "seed": 0}


def test_naive_tables_match_jax(tmp_path, jax_quality):
    raw = str(tmp_path / "raw")
    make_synthetic_dataset(raw, "SYN_Q", num_nodes=6, len_time=24 * 12, seed=5)
    shape = dict(quality_run.SHAPES["dc"], name="SYN_Q", num_nodes=6)
    cfg = load_config("traffic_state_pred", "MultiATGCN", "SYN_Q", other_args=_mth_args(raw, str(tmp_path / "p")))
    ds = get_dataset(cfg, device="cpu")
    _, _, test = ds.get_data()
    quality_run._naive_trans_tables(shape, cfg, ds, test, str(tmp_path / "ours"), 0)
    jcfg = jax_load_config("traffic_state_pred", "MultiATGCN", "SYN_Q", other_args=_mth_args(raw, str(tmp_path / "j")))
    jds = jax_get_dataset(jcfg)
    _, _, jtest = jds.get_data()
    jax_quality._naive_trans_tables(shape, jcfg, jds, jtest, str(tmp_path / "jax"), 0)
    for label in ("persistence", "seasonal"):
        rel = os.path.join("q_SYN_Q_{}_s0".format(label), "evaluate_cache", "{}_0_trans.csv".format(label))
        ours = aggregate_results.read_table(str(tmp_path / "ours" / rel))
        want = pd.read_csv(str(tmp_path / "jax" / rel), index_col=0)
        assert len(ours["index"]) == 24
        ours.pop("Model_time")
        _assert_frame_equal(ours, want.drop(columns="Model_time"))


def _docs_state():
    return sorted((p, os.path.getmtime(p)) for p in glob.glob(os.path.join(REPO, "docs", "**"), recursive=True))


def test_quality_run_end_to_end(tmp_path, monkeypatch):
    docs = _docs_state()
    root = str(tmp_path / "q")
    argv = ["dc", "--device", "cpu", "--num_nodes", "8", "--len_time", "960", "--max_epoch", "1", "--seeds", "0",
            "--models", "MultiATGCN,GRU", "--root", root]
    failures, summary = quality_run.main(argv)
    assert failures == []
    names = list(summary["Model_name"])
    models = ("GRU", "MultiATGCN", "persistence", "seasonal")
    assert len(names) == 16 and sorted(zip(summary["horizon"], names)) == [(h, m) for h in (3, 6, 12, 24)
                                                                            for m in models]
    for c, v in summary.items():
        if c.endswith(("_mean", "_vs_ref_pct")):
            assert np.isfinite(v.astype(np.float64)).all(), c
    assert all(summary["MAE_vs_ref_pct"][i] == 0.0 for i, n in enumerate(names) if n == "MultiATGCN")
    doc = os.path.join(root, "RESULTS_SYN_DC237_S8x960.md")
    with open(doc) as f:
        text = f.read()
    assert "**Margin over the baselines**" in text and "| GRU | 24h |" in text
    summary_csv = os.path.join(root, "RESULTS_SYN_DC237_S8x960_summary.csv")
    with open(summary_csv) as f:
        first = f.read()

    # resume: every run is cached, nothing trains, the same table
    def no_training(self, *args):
        raise AssertionError("a cached run trained again")

    monkeypatch.setattr(TrafficStateExecutor, "train", no_training)
    failures, again = quality_run.main(argv)
    assert failures == []
    with open(summary_csv) as f:
        assert f.read() == first
    # carry-forward: GRU's run is gone and only MultiATGCN is swept; GRU's
    # rows come from the prior summary
    os.rename(os.path.join(root, "outputs", "q_SYN_DC237_S8x960_GRU_s0"), os.path.join(root, "moved"))
    failures, carried = quality_run.main(argv[:-3] + ["MultiATGCN", "--root", root])
    assert failures == [] and list(carried["Model_name"]) == names
    for c in summary:
        np.testing.assert_array_equal(np.asarray(carried[c], dtype=object).astype(str),
                                      np.asarray(summary[c], dtype=object).astype(str), err_msg=c)
    assert _docs_state() == docs
