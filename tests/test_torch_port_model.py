"""The port's MultiATGCN forward against the JAX package on carried weights.

The JAX model's parameters are seeded numpy values at the shapes of
``model.init``; they go to the port through ``state_dict_from_jax``, and
both run the same numpy input. f32 is
held to atol=1e-5, rtol=1e-4 (the same math, another summation order). In
bf16 and int8 both sides round at the same points, and a rounding step that
flips by one bf16 ulp (or one int8 level) on one side propagates through
the recurrence, so port vs JAX in the same mode is held to atol=rtol=1e-2.
The JAX int8 path runs its Pallas kernel in interpret mode on the CPU.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multistgraph_tpu.models import build_multi_atgcn as jax_build
from multistgraph_tpu_torch.models import build_multi_atgcn, get_model
from multistgraph_tpu_torch.utils.jax_import import state_dict_from_jax

N, TIN, TOUT = 8, 24, 6
LEN_C, LEN_P, LEN_T = 2, 1, 1  # in input_window multiples


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other CPU tests use beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _features(with_static, seed=3):
    rng = np.random.default_rng(seed)
    adj = np.abs(rng.normal(size=(N, N))).astype(np.float32)
    np.fill_diagonal(adj, rng.uniform(2, 4, N))
    geo = {
        "geo_id": np.arange(N),
        "type": np.array(["Point"] * N),
        "coordinates": np.array(["[{:.5f}, {:.5f}]".format(-77 + 0.01 * i, 38.9 + 0.008 * i)
                                 for i in range(N)]),
    }
    feature = {
        "num_nodes": N, "adj_mx": adj, "static": rng.normal(size=(N, 5)) if with_static else None,
        "coordinate": geo, "ext_dim": 1, "output_dim": 1, "scaler": None,
        "len_closeness": LEN_C * TIN, "len_period": LEN_P * TIN, "len_trend": LEN_T * TIN,
    }
    jax_feature = dict(feature, coordinate=pd.DataFrame(geo))
    return feature, jax_feature


def _config(**overrides):
    cfg = {
        "model": "MultiATGCN", "input_window": TIN, "output_window": TOUT, "start_dim": 0,
        "end_dim": 1, "rnn_units": 8, "num_layers": 2, "cheb_order": 2, "embed_dim_node": 3,
        "embed_dim_adj": 3, "adjtype": "cosine", "adpadj": "none", "add_time_in_day": True,
        "add_day_in_week": False, "load_dynamic": False, "gcn_off": False, "fnn_off": False,
        "node_specific_off": False,
    }
    cfg.update(overrides)
    return cfg


def _input(batch=3, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, (LEN_C + LEN_P + LEN_T) * TIN, N, 2)).astype(np.float32)
    x[..., 1] = rng.uniform(size=x.shape[:3])  # time-in-day fraction
    return x


def _params(jmodel, x, seed=11):
    """Seeded numpy values at the shapes of ``jmodel.init``'s parameters.

    ``jax.eval_shape`` traces the init without compiling it (an eager init
    takes seconds on the CPU), and random values exercise every parameter,
    biases included, where an init leaves some at zero.
    """
    shapes = jax.eval_shape(lambda k, x: jmodel.init(k, x, train=False), jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=v.shape) * 0.3).astype(v.dtype) for k, v in shapes["params"].items()}


def _both(cfg, with_static=False):
    feature, jax_feature = _features(with_static)
    jmodel = jax_build(cfg, jax_feature)
    x = _input()
    flat = _params(jmodel, x)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, train=False))(flat, x)
    model = build_multi_atgcn(cfg, feature, device="cpu")
    model.load_state_dict(state_dict_from_jax(flat, model))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    return got.numpy(), np.asarray(want), model, jmodel


@pytest.mark.parametrize("adjtype,adpadj,with_static", [
    ("cosine", "none", False),
    ("multi", "none", False),
    ("multi", "bidirection", False),
    ("od", "unidirection", False),
    ("multi", "bidirection", True),
])
def test_f32_forward_matches_jax(adjtype, adpadj, with_static):
    got, want, model, jmodel = _both(_config(adjtype=adjtype, adpadj=adpadj), with_static)
    assert got.shape == (3, TOUT, N, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(model.supports_static.numpy(), jmodel.supports_static, atol=1e-6)
    if with_static:
        np.testing.assert_allclose(model.static_proj.numpy(), jmodel.static_proj, atol=1e-6)


@pytest.mark.parametrize("flag", ["gcn_off", "fnn_off", "node_specific_off"])
def test_f32_ablations_match_jax(flag):
    got, want, model, _ = _both(_config(adjtype="multi", adpadj="bidirection", num_layers=1,
                                        **{flag: True}))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    if flag == "node_specific_off":
        assert "node_emb" not in dict(model.named_parameters())


@pytest.mark.parametrize("mode", [
    {"compute_dtype": "bfloat16"},
    {"compute_dtype": "bfloat16", "weight_stream_quant": "int8"},
    # the int8 stream at f32 activations: no rounding point but the int8
    # weights, which both sides quantize alike, so held as f32 is
    {"compute_dtype": "float32", "weight_stream_quant": "int8"},
    {"compute_dtype": "float16", "weight_stream_quant": "int8"},
])
def test_bf16_and_int8_forward_match_jax(mode):
    got, want, model, _ = _both(_config(adjtype="multi", adpadj="bidirection", **mode),
                                with_static=True)
    assert model.uses_int8_stream == ("weight_stream_quant" in mode)
    assert np.isfinite(got).all()
    if mode["compute_dtype"] == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)


def test_int8_needs_compute_dtype_like_jax():
    feature, _ = _features(False)
    model = build_multi_atgcn(_config(weight_stream_quant="int8"), feature, device="cpu")
    assert not model.uses_int8_stream  # silently ignored without compute_dtype, as in JAX


def test_registry_and_seeded_init():
    feature, _ = _features(True)
    cfg = _config(adjtype="multi", adpadj="bidirection", seed=4)
    a = get_model(cfg, feature, device="cpu")
    b = get_model(cfg, feature, device="cpu", generator=torch.Generator().manual_seed(4))
    for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    assert a.end_conv.weight.shape == (TOUT, TIN, 1, 8)
    assert a.encoder.res_cells[0].gate.weight.shape == (16, 2 + 8)


def test_inconsistent_load_dynamic_raises():
    feature, _ = _features(False)
    feature["ext_dim"] = 6
    with pytest.raises(ValueError, match="load_dynamic"):
        build_multi_atgcn(_config(), feature, device="cpu")
    model = build_multi_atgcn(_config(load_dynamic=True), feature, device="cpu")
    assert model.feature_final == 7
