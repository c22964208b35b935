"""The port's hand-written BPTT against the JAX package's.

Each test makes its inputs with numpy from a seed and runs the JAX function
under ``jax.jit(jax.value_and_grad(...))``, as the JAX executor runs it,
and the port's counterpart under autograd, on the same values. The JAX
int8 layer runs its Pallas kernels in interpret mode on the CPU (it picks
that itself off the TPU); the port runs its plain kernels. Errors are the
max abs difference over the JAX value's max abs value, per cotangent:
  * f32: atol 2e-5, rtol 2e-4 elementwise (the same math in another
    summation order; the readings are below 8e-7 relative);
  * bf16 and int8: 2e-2 relative for the layers, 5e-2 for the full models.
    Both sides round the same operands to bf16, but a last-bit f32
    difference flips a rounding now and then, and the recurrence carries it
    (readings: up to 6.7e-3 for the layers; 1.7e-2 for the full bf16 model,
    at ``weight_tsg``, whose 3 entries sum many cancelling terms, and
    9.8e-3 for the int8 model).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multistgraph_tpu.models import build_multi_atgcn as jax_build
from multistgraph_tpu.models.multi_atgcn import fused_atgru_layer as jax_layer
from multistgraph_tpu.models.multi_atgcn import fused_atgru_layer_q8 as jax_layer_q8
from multistgraph_tpu.models.multi_atgcn import make_loss_fn as jax_make_loss_fn
from multistgraph_tpu_torch.models import build_multi_atgcn
from multistgraph_tpu_torch.models.multi_atgcn import fused_atgru_layer, fused_atgru_layer_q8
from multistgraph_tpu_torch.ops.losses import make_loss_fn
from multistgraph_tpu_torch.utils.jax_import import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of tiny CPU ops, and
    beside other test workers on the same cores an OpenMP team per op
    spends far more time waiting than working."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

T, B = 5, 3
ORDER = ("gate_x", "upd_x", "rg_x", "ru_x", "w_seq", "supports", "wg_h", "wu_h",
         "bg", "bu", "rg_h", "ru_h", "rg_b", "ru_b", "state0")
COMPUTE_DTYPE_ARGS = ("gate_x", "upd_x", "rg_x", "ru_x", "wg_h", "wu_h")
BF16_REL = 2e-2
BF16_MODEL_REL = 5e-2


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _layer_inputs(seed, n, h, k, n_major):
    """The inputs of tests/test_fused_bptt.py:_inputs; (T,N,B,*) when n_major."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    lead = (T, n, B) if n_major else (T, B, n)
    kw = dict(gate_x=f(*lead, 2 * h), upd_x=f(*lead, h), rg_x=f(*lead, 2 * h), ru_x=f(*lead, h),
              w_seq=(1.0 / (1.0 + np.exp(-f(T)))).astype(np.float32),
              supports=f(k, n, n) / np.sqrt(n), wg_h=f(n, k, h, 2 * h) * 0.3,
              wu_h=f(n, k, h, h) * 0.3, bg=f(n, 2 * h), bu=f(n, h), rg_h=f(h, 2 * h),
              ru_h=f(h, h), rg_b=f(2 * h), ru_b=f(h),
              state0=f(n, B, h) if n_major else f(B, n, h))
    weights = rng.normal(size=(T,) + kw["state0"].shape).astype(np.float32)
    return {k: v.astype(np.float32) for k, v in kw.items()}, weights


def _layer_grads(jax_fn, torch_fn, jax_dtype, torch_dtype, kw, weights):
    """value and the 15 input cotangents of sum(layer(...) * weights), JAX and port."""

    def jax_loss(args):
        args = [a.astype(jax_dtype) if jax_dtype is not None and k in COMPUTE_DTYPE_ARGS else a
                for k, a in zip(ORDER, args)]
        return jnp.sum(jax_fn(jax_dtype, *args) * weights)

    value, grads = jax.jit(jax.value_and_grad(jax_loss))(tuple(jnp.asarray(kw[k]) for k in ORDER))
    leaves = [torch.tensor(kw[k], requires_grad=True) for k in ORDER]
    args = [a.to(torch_dtype) if torch_dtype is not None and k in COMPUTE_DTYPE_ARGS else a
            for k, a in zip(ORDER, leaves)]
    loss = (torch_fn(torch_dtype, *args) * torch.from_numpy(weights)).sum()
    loss.backward()
    return (float(value), [np.asarray(g, np.float32) for g in grads],
            float(loss.detach()), [a.grad.numpy() for a in leaves])


def test_fused_layer_f32_value_and_all_cotangents_match_jax():
    kw, weights = _layer_inputs(0, n=7, h=4, k=2, n_major=False)
    want_v, want_g, got_v, got_g = _layer_grads(jax_layer, fused_atgru_layer, None, None, kw, weights)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6)
    for name, got, want in zip(ORDER, got_g, want_g):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4, err_msg=name)


@pytest.mark.parametrize("jax_fn,torch_fn,n,h,n_major,dtype", [
    (jax_layer, fused_atgru_layer, 7, 4, False, "bfloat16"),
    (jax_layer_q8, fused_atgru_layer_q8, 16, 8, True, "bfloat16"),  # tests/test_fused_bptt.py:197-263 sizes
    # the int8 stream at f32 activations: B2 and B2t take f32 operands, the
    # only rounding points are the int8 weights and B2t's bf16 cotangent,
    # which both sides share, so held as f32 is
    (jax_layer_q8, fused_atgru_layer_q8, 16, 8, True, "float32"),
], ids=["bf16", "int8", "int8-f32"])
def test_fused_layer_bf16_and_int8_value_and_all_cotangents_match_jax(jax_fn, torch_fn, n, h, n_major, dtype):
    kw, weights = _layer_inputs(0, n=n, h=h, k=2, n_major=n_major)
    want_v, want_g, got_v, got_g = _layer_grads(jax_fn, torch_fn, jnp.dtype(dtype), getattr(torch, dtype),
                                                kw, weights)
    if dtype == "float32":
        np.testing.assert_allclose(got_v, want_v, rtol=1e-6)
    else:
        assert abs(got_v - want_v) <= BF16_REL * abs(want_v)
    for name, got, want in zip(ORDER, got_g, want_g):
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4, err_msg=name)
        else:
            assert _rel_err(got, want) < BF16_REL, (name, _rel_err(got, want))


def test_fused_layer_int8_launches_b2_forward_and_b2t_backward_twice_per_step():
    from multistgraph_tpu_torch.models import multi_atgcn

    kw, _ = _layer_inputs(1, n=16, h=8, k=2, n_major=True)
    args = [torch.tensor(kw[k], requires_grad=True) for k in ORDER]
    args = [a.to(torch.bfloat16) if k in COMPUTE_DTYPE_ARGS else a for k, a in zip(ORDER, args)]
    calls = {"fwd": 0, "bwd": 0}

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(multi_atgcn, "node_apply_q8", count("fwd", multi_atgcn.node_apply_q8))
        mp.setattr(multi_atgcn, "node_apply_q8_t", count("bwd", multi_atgcn.node_apply_q8_t))
        states = fused_atgru_layer_q8(torch.bfloat16, *args)
        assert calls == {"fwd": 2 * T, "bwd": 0}
        states.sum().backward()
    assert calls == {"fwd": 2 * T, "bwd": 2 * T}


# ------------------------------------------------------------ the full model

N, TIN, TOUT = 6, 24, 6


def _model_setup(**overrides):
    """The tiny model of tests/test_fused_bptt.py:100-123."""
    rng = np.random.default_rng(5)
    geo = {"geo_id": np.arange(N), "type": np.array(["Point"] * N),
           "coordinates": np.array(["[{:.4f}, {:.4f}]".format(-77 + 0.01 * i, 38.9) for i in range(N)])}
    feature = {"num_nodes": N, "adj_mx": np.abs(rng.normal(size=(N, N))).astype(np.float32),
               "static": rng.normal(size=(N, 4)), "coordinate": geo, "ext_dim": 1, "output_dim": 1,
               "len_closeness": TIN, "len_period": TIN, "len_trend": TIN, "scaler": None}
    config = {"model": "MultiATGCN", "input_window": TIN, "output_window": TOUT, "start_dim": 0,
              "end_dim": 1, "rnn_units": 4, "num_layers": 2, "cheb_order": 2, "embed_dim_node": 3,
              "embed_dim_adj": 3, "adjtype": "multi", "adpadj": "bidirection",
              "add_time_in_day": True, "load_dynamic": False}
    config.update(overrides)
    return config, feature, dict(feature, coordinate=pd.DataFrame(geo))


class _Scaler:
    def inverse_transform(self, v):
        return v * 2.0 + 1.0


def _batch(seed=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 3 * TIN, N, 2)).astype(np.float32)
    y = np.abs(rng.normal(size=(2, TOUT, N, 2))).astype(np.float32)
    y[0, 0, 0, 0] = 0.0  # a masked label (null_val 0)
    return x, y


def _model_grads(jax_side=True, **overrides):
    """The loss and every parameter gradient of the port's model and, with
    `jax_side`, of the JAX model (its value_and_grad jitted, as the JAX
    executor runs it) at the same random weights."""
    config, feature, jax_feature = _model_setup(**overrides)
    jmodel = jax_build(config, jax_feature)
    x, y = _batch()
    shapes = jax.eval_shape(lambda k, x: jmodel.init(k, x, train=False), jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(11)
    flat = {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in shapes["params"].items()}
    if jax_side:
        loss_fn = jax_make_loss_fn(jmodel, _Scaler())
        want_v, want_g = jax.jit(jax.value_and_grad(
            lambda p: loss_fn({"params": p}, {"X": x, "y": y}, train=False)))(flat)

    model = build_multi_atgcn(config, feature, device="cpu")
    model.load_state_dict(state_dict_from_jax(flat, model))
    got = make_loss_fn(model, _Scaler())({"X": torch.from_numpy(x), "y": torch.from_numpy(y)}, train=False)
    got.backward()
    # a parameter the loss does not reach (node_vec1/2 under the
    # bidirectional view) has no .grad in torch and a zero cotangent in JAX
    got_g = {name: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
             for name, p in model.named_parameters()}
    if not jax_side:
        return None, float(got.detach()), {k: (g, None) for k, g in got_g.items()}, model
    want_g = state_dict_from_jax({k: np.asarray(v["params"] if isinstance(v, dict) else v)
                                  for k, v in want_g.items()}, model)
    assert set(got_g) == set(want_g)
    return float(want_v), float(got.detach()), {k: (got_g[k], want_g[k].numpy()) for k in got_g}, model


def test_full_model_f32_loss_and_every_parameter_gradient_match_jax():
    want_v, got_v, grads, _ = _model_grads()
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6)
    for name, (got, want) in grads.items():
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4, err_msg=name)


@pytest.mark.parametrize("mode", [
    {"compute_dtype": "bfloat16"},
    {"compute_dtype": "bfloat16", "weight_stream_quant": "int8"},
    {"compute_dtype": "float32", "weight_stream_quant": "int8"},
], ids=["bf16", "int8", "int8-f32"])
def test_full_model_bf16_and_int8_loss_and_every_parameter_gradient_match_jax(mode):
    """In bf16 the rounding flips that the recurrence carries bound the
    error; at f32 activations the int8 model is held as the f32 one is
    (readings: loss 9.2e-8 relative, gradients within 6.2e-7 relative)."""
    want_v, got_v, grads, model = _model_grads(**mode)
    assert model.uses_int8_stream == ("weight_stream_quant" in mode)
    f32 = mode["compute_dtype"] == "float32"
    if f32:
        np.testing.assert_allclose(got_v, want_v, rtol=1e-6)
    else:
        assert abs(got_v - want_v) <= BF16_MODEL_REL * abs(want_v)
    for name, (got, want) in grads.items():
        assert np.isfinite(got).all(), name
        if f32:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4, err_msg=name)
        else:
            assert _rel_err(got, want) < BF16_MODEL_REL, (name, _rel_err(got, want))


def test_plain_autograd_without_fused_bptt_matches_the_fused_backward():
    """fused_bptt=False takes autograd of the step loop, as JAX does
    (multi_atgcn.py:816-826); the two backward passes agree."""
    _, _, grads_fused, fused = _model_grads(jax_side=False)
    _, _, grads_plain, plain = _model_grads(jax_side=False, fused_bptt=False)
    assert fused.fused_bptt and not plain.fused_bptt
    for name, (got, _) in grads_plain.items():
        np.testing.assert_allclose(got, grads_fused[name][0], atol=2e-5, rtol=2e-4, err_msg=name)


def test_dropout_mask_rate_and_scale_in_train_mode():
    config, feature, _ = _model_setup()
    model = build_multi_atgcn(config, feature, device="cpu")
    assert model.dropout_rate == 0.1  # the JAX module's default
    states = torch.ones(64, TIN, N, 4)
    dropped = model._dropout(states, True, torch.Generator().manual_seed(0))
    assert torch.equal(dropped, model._dropout(states, True, torch.Generator().manual_seed(0)))
    values = torch.unique(dropped).tolist()
    assert len(values) == 2 and values[0] == 0.0 and values[1] == pytest.approx(1.0 / 0.9)
    rate = float((dropped == 0).float().mean())
    assert abs(rate - 0.1) < 0.01, rate  # 36864 draws: the bound is 6 standard deviations
    assert model._dropout(states, False, None) is states
    # the forward drops only in train mode
    x = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        plain = model(x)
        dropped_out = model(x, train=True, generator=torch.Generator().manual_seed(1))
        assert torch.equal(model(x), plain)
    assert not torch.equal(dropped_out, plain)
