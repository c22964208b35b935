"""The port's weight-only quantization (multistgraph_tpu_torch/ops/quantize.py)
and quantized PredictService against the JAX package's.

No training: seeded weights at the JAX model's shapes are carried across by
``state_dict_from_jax``. Held, each with its tolerance:
  * ``quantize_params``: the int8 levels equal JAX's (after the layout
    transposes ``state_dict_from_jax`` applies), scales equal, bf16 casts
    equal; ``quantized_nbytes`` equal;
  * the quantized services' predictions against the JAX quantized
    service's on the same weights and windows: rtol 1e-5 with atol 1e-5
    times max |JAX| (both compute in f32 from the same dequantized
    weights; de-z-scoring multiplies by per-node stds of tens);
  * JAX's own bounds (tests/test_serving_quantized.py): relative L1 of the
    int8 and bf16 replies against the unquantized service < 1%, int8
    bytes < 0.5x, bf16 <= 0.51x;
  * the HTTP round trip, ``stats()``'s keys, and ``serve_model --quantize``.
"""

import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from multistgraph_tpu.config import load_config as jax_load_config
from multistgraph_tpu.data import get_dataset as jax_get_dataset
from multistgraph_tpu.models import get_model as jax_get_model
from multistgraph_tpu.ops import quantize as jax_quantize
from multistgraph_tpu.serving import PredictService as JaxPredictService
from multistgraph_tpu_torch import serve_model
from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.models import get_model
from multistgraph_tpu_torch.ops.quantize import dequantize_params, quantize_params, quantized_nbytes
from multistgraph_tpu_torch.serving import PredictService, make_server
from multistgraph_tpu_torch.utils.jax_import import _torch_entry, state_dict_from_jax

TASK, MODEL, DATASET = "traffic_state_pred", "MultiATGCN", "SYN_SMALL"
MODES = ("int8", "bfloat16")


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
        "output_dir": str(tmp_path / "out"), "exp_id": "serveq",
        "len_closeness": 1, "len_period": 1, "len_trend": 1,
        "interval_period": 2, "interval_trend": 4,
        "input_window": 24, "output_window": 3,
        "load_external": True, "load_dynamic": False, "add_time_in_day": True,
        "groupstd": True, "batch_size": 4, "train_rate": 0.7, "eval_rate": 0.15,
        "rnn_units": 8, "embed_dim_node": 3, "embed_dim_adj": 3, "seed": 0, "tensorboard": False,
    }


@pytest.fixture(scope="module")
def setup(synthetic_dataset, tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("port_quantize")
    args = _args(synthetic_dataset, tmp_path)
    jcfg = jax_load_config(TASK, MODEL, DATASET, other_args=args)
    jds = jax_get_dataset(jcfg)
    _, _, jtest = jds.get_data()
    jfeature = jds.get_data_feature()
    jmodel = jax_get_model(jcfg, jfeature)
    x = np.asarray(jtest.x)[:8]
    # seeded values at the shapes of the init (traced, not compiled), as
    # tests/test_torch_port_model.py makes them
    shapes = jax.eval_shape(lambda key, xx: jmodel.init(key, xx, train=False), jax.random.PRNGKey(0), x[:1])
    rng = np.random.default_rng(11)
    params = {"params": {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32)
                         for k, v in shapes["params"].items()}}
    jax_services = {mode: JaxPredictService(jmodel, params, jfeature["scaler"], max_batch=8,
                                            ct_visit_mstd=jfeature["ct_visit_mstd"], quantize=mode)
                    for mode in (None,) + MODES}

    cfg = load_config(TASK, MODEL, DATASET, other_args=args)
    ds = get_dataset(cfg, device="cpu")
    ds.get_data()
    model = get_model(cfg, ds.get_data_feature(), device="cpu")
    flat = {k: np.asarray(v) for k, v in params["params"].items()}
    cache = os.path.join(args["output_dir"], "serveq", "model_cache", "{}_{}.pt".format(MODEL, DATASET))
    os.makedirs(os.path.dirname(cache))
    torch.save((state_dict_from_jax(flat, model), {}), cache)
    return {"args": args, "x": x, "flat": flat, "model": model, "jax_services": jax_services,
            "jax_params": params["params"]}


def _service(setup, quantize):
    return PredictService.from_experiment(TASK, MODEL, DATASET, other_args=setup["args"], max_batch=8,
                                          device="cpu", quantize=quantize)


def test_int8_levels_and_scales_are_jax_bit_for_bit(setup):
    want = jax_quantize.quantize_params(setup["jax_params"], mode="int8")
    got = quantize_params(state_dict_from_jax(setup["flat"], setup["model"]), mode="int8")
    quantized = 0
    for name, leaf in want.items():
        if isinstance(leaf, dict):
            torch_name, levels = _torch_entry(name, np.asarray(leaf["__q8__"], np.float32), setup["model"])
            entry = got[torch_name]
            assert entry["q8"].dtype == torch.int8
            np.testing.assert_array_equal(entry["q8"].numpy().astype(np.float32), levels, err_msg=name)
            assert entry["scale"].dtype == torch.float32 and entry["scale"].dim() == 0
            assert float(entry["scale"]) == float(np.asarray(leaf["scale"])), name
            quantized += 1
        else:
            torch_name, value = _torch_entry(name, np.asarray(leaf, np.float32), setup["model"])
            np.testing.assert_array_equal(got[torch_name].numpy(), value, err_msg=name)
    assert quantized == sum(isinstance(v, dict) for v in got.values()) > 0 and len(got) == len(want)
    # the inverse, in f32, as JAX's dequantize_params
    back = dequantize_params(got)
    jback = jax_quantize.dequantize_params(want)
    for name, value in jback.items():
        torch_name, v = _torch_entry(name, np.asarray(value, np.float32), setup["model"])
        np.testing.assert_array_equal(back[torch_name].numpy(), v, err_msg=name)


@pytest.mark.parametrize("mode", (None,) + MODES, ids=["plain", "int8", "bfloat16"])
def test_quantized_nbytes_equal_jax(setup, mode):
    state = state_dict_from_jax(setup["flat"], setup["model"])
    got = quantized_nbytes(quantize_params(state, mode=mode) if mode else state)
    tree = jax_quantize.quantize_params(setup["jax_params"], mode=mode) if mode else setup["jax_params"]
    assert got == jax_quantize.quantized_nbytes(tree)
    if mode == "bfloat16":
        assert all(t.dtype == torch.bfloat16 for t in quantize_params(state, mode=mode).values())


@pytest.mark.parametrize("mode", MODES)
def test_quantized_service_matches_jax(setup, mode):
    service = _service(setup, mode)
    # stored quantized; the module's own full-precision storage released
    assert all(p.numel() == 0 for p in service.model.parameters())
    x = setup["x"]
    got = service.predict(x[:5])
    want = setup["jax_services"][mode].predict(x[:5])
    assert got.shape == want.shape == (5, 3, 8, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert service.stats()["quantize"] == mode == setup["jax_services"][mode].stats()["quantize"]
    assert service.stats()["param_bytes"] == setup["jax_services"][mode].stats()["param_bytes"]


@pytest.mark.parametrize("mode", MODES)
def test_quantized_replies_within_jax_bounds(setup, mode):
    x = setup["x"]
    y_full = _service(setup, None).predict(x)
    y_q = _service(setup, mode).predict(x)
    rel = np.abs(y_q - y_full).mean() / max(np.abs(y_full).mean(), 1e-9)
    assert 0 < rel < 0.01, "{} weight-only rel-L1 {:.4%} >= 1%".format(mode, rel)


def test_quantized_param_bytes_shrink(setup):
    full = _service(setup, None).stats()["param_bytes"]
    q8 = _service(setup, "int8").stats()["param_bytes"]
    qb = _service(setup, "bfloat16").stats()["param_bytes"]
    assert q8 < 0.5 * full and qb <= 0.51 * full


def test_quantized_http_roundtrip_and_stats(setup):
    service = _service(setup, "int8")
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address
        req = urllib.request.Request("http://{}:{}/predict".format(host, port),
                                     data=json.dumps({"x": setup["x"][:2].tolist()}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        assert out["shape"][0] == 2
        with urllib.request.urlopen("http://{}:{}/health".format(host, port), timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["quantize"] == "int8" and health["status"] == "ok"
    finally:
        server.shutdown()
        server.server_close()
    assert set(service.stats()) == set(setup["jax_services"]["int8"].stats())


def test_serve_model_quantize_flag(setup, monkeypatch):
    calls = {}

    def from_experiment(*args, **kwargs):
        calls.update(kwargs)
        return "service"

    monkeypatch.setattr(serve_model.PredictService, "from_experiment", from_experiment)
    monkeypatch.setattr(serve_model, "serve", lambda service, port, host: calls.update(served=service))
    serve_model.main(["--dataset", DATASET, "--exp_id", "serveq", "--quantize", "int8", "--device", "cpu"])
    assert calls["quantize"] == "int8" and calls["served"] == "service"
    assert "quantize" not in calls["other_args"]
