"""The port's PredictService (multistgraph_tpu_torch/serving.py) against the JAX service.

The port's service is built by ``from_experiment`` from a .pt written with
``state_dict_from_jax``; the JAX ``PredictService`` holds the same
parameters. Both predict the same windows in measurement space (scaler
inverse, group de-z-scoring, clip at 0): rtol=1e-4, atol=1e-3, since
de-z-scoring multiplies the model's f32 differences by per-node stds of
tens. Then the bucket, padding, chunking, rank and HTTP cases of
tests/test_serving.py on the port, on the CPU.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from multistgraph_tpu.config import load_config as jax_load_config
from multistgraph_tpu.data import get_dataset as jax_get_dataset
from multistgraph_tpu.models import get_model as jax_get_model
from multistgraph_tpu.serving import PredictService as JaxPredictService
from multistgraph_tpu_torch import serve_model
from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.models import get_model
from multistgraph_tpu_torch.serving import PredictService, make_server
from multistgraph_tpu_torch.utils.jax_import import state_dict_from_jax

TASK, MODEL, DATASET = "traffic_state_pred", "MultiATGCN", "SYN_SMALL"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other CPU tests use beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(data_dir, tmp_path):
    return {
        "data_dir": data_dir, "cache_dir": str(tmp_path / "cache"),
        "output_dir": str(tmp_path / "out"), "exp_id": "serve",
        "len_closeness": 1, "len_period": 1, "len_trend": 1,
        "interval_period": 2, "interval_trend": 4,
        "input_window": 24, "output_window": 6,
        "load_external": True, "load_dynamic": False, "add_time_in_day": True,
        "groupstd": True, "add_static": True, "adjtype": "multi", "adpadj": "bidirection",
        "batch_size": 4, "train_rate": 0.7, "eval_rate": 0.15,
        "rnn_units": 8, "embed_dim_node": 3, "embed_dim_adj": 3, "seed": 0,
    }


@pytest.fixture(scope="module")
def services(synthetic_dataset, tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("port_serving")
    args = _args(synthetic_dataset, tmp_path)
    jcfg = jax_load_config(TASK, MODEL, DATASET, other_args=args)
    jds = jax_get_dataset(jcfg)
    _, _, jtest = jds.get_data()
    jfeature = jds.get_data_feature()
    jmodel = jax_get_model(jcfg, jfeature)
    x = np.asarray(jtest.x)
    # jitted: the same parameters as an eager init, in a quarter of the time
    params = jax.jit(lambda key, xx: jmodel.init(key, xx, train=False))(jax.random.PRNGKey(0), x[:1])
    jax_service = JaxPredictService(jmodel, params, jfeature["scaler"], max_batch=8,
                                    ct_visit_mstd=jfeature["ct_visit_mstd"])

    cfg = load_config(TASK, MODEL, DATASET, other_args=args)
    ds = get_dataset(cfg, device="cpu")
    ds.get_data()
    model = get_model(cfg, ds.get_data_feature(), device="cpu")
    flat = {k: np.asarray(v) for k, v in params["params"].items()}
    cache = os.path.join(args["output_dir"], "serve", "model_cache", "{}_{}.pt".format(MODEL, DATASET))
    os.makedirs(os.path.dirname(cache))
    torch.save((state_dict_from_jax(flat, model), {}), cache)
    service = PredictService.from_experiment(TASK, MODEL, DATASET, other_args=args, max_batch=8,
                                             device="cpu")
    return service, jax_service, x, args


def test_predictions_match_jax_service(services):
    service, jax_service, x, _ = services
    got = service.predict(x[:5])
    want = jax_service.predict(x[:5])
    assert got.shape == want.shape == (5, 6, 8, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_predict_shapes_and_padding(services):
    service, _, x, _ = services
    service._buckets.clear()
    y3 = service.predict(x[:3])
    assert y3.shape[:2] == (3, 6)
    y1 = service.predict(x[:1])
    np.testing.assert_allclose(y1[0], y3[0], rtol=1e-5, atol=1e-5)
    assert service.stats()["compiled_buckets"] == [1, 4]


def test_predict_chunks_large_batches(services):
    service, _, x, _ = services
    n = min(len(x), 11)  # > max_batch=8 forces chunking
    y = service.predict(x[:n])
    assert y.shape[0] == n
    np.testing.assert_allclose(y, service.predict(x[:n]), rtol=0, atol=0)


def test_predict_is_group_destandardized_and_nonnegative(services):
    service, _, x, _ = services
    assert (service.predict(x[:4]) >= 0).all()
    stats = service.stats()
    assert stats["group_destandardize"] is True and stats["device"] == "cpu"
    assert set(stats) == {"requests_served", "compiled_buckets", "max_batch", "device",
                          "group_destandardize", "quantize", "param_bytes"}


def test_rejects_bad_rank(services):
    service, _, x, _ = services
    with pytest.raises(ValueError, match="expected"):
        service.predict(x[0])


def test_http_roundtrip(services):
    service, _, x, _ = services
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address
        with urllib.request.urlopen("http://{}:{}/health".format(host, port), timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        body = json.dumps({"x": x[:2].tolist()}).encode()
        req = urllib.request.Request("http://{}:{}/predict".format(host, port), data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            reply = json.loads(r.read())
        np.testing.assert_allclose(np.asarray(reply["prediction"], np.float32),
                                   service.predict(x[:2]), rtol=1e-5, atol=1e-5)
        bad = urllib.request.Request("http://{}:{}/predict".format(host, port), data=b"{}",
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_entry_points_raise_without_cuda(services, monkeypatch):
    service, _, _, args = services
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PredictService(service.model, service.scaler)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PredictService.from_experiment(TASK, MODEL, DATASET, other_args=args)
    cfg = load_config(TASK, MODEL, DATASET, other_args=args)
    ds = get_dataset(cfg, device="cpu")
    ds.get_data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(cfg, ds.get_data_feature())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_model.main(["--dataset", DATASET, "--exp_id", "serve", "--data_dir", args["data_dir"]])
