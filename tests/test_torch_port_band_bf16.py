"""The port's bf16 band path against the JAX package: the band products in
bf16 (planes and packed rows, values and gradients, and the mixed case of
bf16 x against f32 values) and in f16, ``round_cotangent``, and SparseATGCN
with ``compute_dtype='bfloat16'`` on the band form, on the same numpy inputs.

JAX's band path runs on its default einsum dispatch (on the CPU it widens
bf16 to f32, sums in f32 and rounds once, as the port's plain versions and
its kernels do). Tolerances, each with its reason:
  * band products: within one bf16 step of JAX, 2^-7 |JAX| + 2^-7 * 1e-3
    max|JAX| (the same exact products summed in f32 in another order, then
    rounded once: the two sums may round to neighbouring bf16 values); an
    f32 dV, rtol 1e-5 with atol 1e-5 times max|JAX|; in f16, within one
    f16 step, 2^-10 |JAX| + 2^-10 * 1e-3 max|JAX|, for the same reason;
  * the model: the relative max error (max |port - JAX| over max |JAX|) of
    the output and of every gradient below 3e-2. Readings on this seed:
    0.77e-2 to 2.1e-2. XLA fuses bf16 elementwise chains and rounds once
    per fusion where PyTorch rounds after every op, so the two packages
    differ by bf16 rounding noise compounded over the recurrence: JAX's own
    bf16 run differs from its f32 run by 0.84e-2 to 4.4e-2 on the same
    inputs. The algorithm is held at 1e-5 in f32 by
    test_torch_port_band_model.py; here the test shows that the bf16 path
    is the same function with the same rounding points at bf16 precision
    (and that it does round: it differs from JAX's f32 run by over 1e-3).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multistgraph_tpu.models.sparse_atgcn import build_sparse_atgcn as jax_build
from multistgraph_tpu.ops import band as jax_band
from multistgraph_tpu.ops.precision import round_cotangent as jax_round_cotangent
from multistgraph_tpu_torch import run_model as run_model_cli
from multistgraph_tpu_torch.models.sparse_atgcn import build_sparse_atgcn
from multistgraph_tpu_torch.ops import band
from multistgraph_tpu_torch.ops.precision import round_cotangent
from multistgraph_tpu_torch.utils.jax_import import state_dict_from_jax

NODES, N_PAD, B, T = 600, 640, 2, 4
BLOCK = 128
MODEL_BOUND = 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other CPU tests use beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _band_edges():
    """tests/test_torch_port_band_model.py's graph: a band of locality 200
    over 5 row blocks, three popular columns (diagonal -3 and a hub column)
    and four scattered far edges (the COO tail)."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, NODES, 4000)
    dst = np.clip(src + rng.integers(-200, 201, 4000), 0, NODES - 1)
    hub_src = rng.integers(0, NODES, 300)
    hub_dst = rng.choice([17, 290, 555], 300)
    far_src, far_dst = np.array([3, 40, 590, 520]), np.array([560, 130, 10, 205])
    w = rng.uniform(0.1, 1.0, 4304).astype(np.float32)
    return np.concatenate([src, hub_src, far_src]), np.concatenate([dst, hub_dst, far_dst]), w


@pytest.fixture(scope="module")
def graphs():
    edges = _band_edges()
    return (band.split_band(*edges, NODES, BLOCK, min_fill_frac=0.5),
            jax_band.split_band(*edges, NODES, BLOCK, min_fill_frac=0.5))


def _bf16(a):
    """numpy f32 -> (torch bf16, jnp bf16) holding the same values."""
    t = torch.from_numpy(np.ascontiguousarray(a)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f16(a):
    """numpy f32 -> (torch f16, jnp f16) holding the same values."""
    t = torch.from_numpy(np.ascontiguousarray(a)).half()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.float16)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.detach().float().numpy()


def _within_a_bf16_step(got, want, step=2.0 ** -7):
    got, want = _np(got), _np(want)
    bound = step * (np.abs(want) + 1e-3 * np.abs(want).max())
    assert (np.abs(got - want) <= bound).all(), float((np.abs(got - want) / bound).max())


# ----------------------------------------------------------------- band ops
@pytest.mark.parametrize("packed", [False, True], ids=["planes", "packed"])
def test_bf16_band_products_and_gradients_match_jax(graphs, packed):
    graph, _ = graphs
    offs = tuple(int(o) for o in graph.offsets)
    radius = band.band_radius(offs)
    rng = np.random.default_rng(1)
    values = band.pack_band_rows(graph.band_values, offs, radius) if packed else graph.band_values
    v_t, v_j = _bf16(values)
    x_t, x_j = _bf16(rng.normal(size=(N_PAD, 24)).astype(np.float32))
    cot_t, cot_j = _bf16(rng.normal(size=(N_PAD, 24)).astype(np.float32))

    def jfn(v, x):
        return (jax_band.spmm_band_packed(v, radius, x, block=BLOCK) if packed
                else jax_band.spmm_band(v, graph.offsets, x, block=BLOCK))

    y_j, vjp = jax.vjp(jfn, v_j, x_j)
    gv_j, gx_j = vjp(cot_j)
    v_t.requires_grad_()
    x_t.requires_grad_()
    y_t = band.spmm_band_packed(v_t, radius, x_t) if packed else band.spmm_band(v_t, offs, x_t)
    y_t.backward(cot_t)
    assert y_t.dtype == v_t.grad.dtype == x_t.grad.dtype == torch.bfloat16
    assert y_j.dtype == gv_j.dtype == gx_j.dtype == jnp.bfloat16
    for got, want in ((y_t, y_j), (v_t.grad, gv_j), (x_t.grad, gx_j)):
        _within_a_bf16_step(got, want)


@pytest.mark.parametrize("packed", [False, True], ids=["planes", "packed"])
def test_f16_band_products_and_gradients_match_jax(graphs, packed):
    """The band products in f16: y, dX and dV in f16 (x's and the values'
    dtype), each within one f16 step of JAX's; the cotangent rounded to f16
    before the backward's products, as JAX rounds it (band.py:727)."""
    graph, _ = graphs
    offs = tuple(int(o) for o in graph.offsets)
    radius = band.band_radius(offs)
    rng = np.random.default_rng(1)
    values = band.pack_band_rows(graph.band_values, offs, radius) if packed else graph.band_values
    v_t, v_j = _f16(values)
    x_t, x_j = _f16(rng.normal(size=(N_PAD, 24)).astype(np.float32))
    cot = rng.normal(size=(N_PAD, 24)).astype(np.float32)

    def jfn(v, x):
        return (jax_band.spmm_band_packed(v, radius, x, block=BLOCK) if packed
                else jax_band.spmm_band(v, graph.offsets, x, block=BLOCK))

    y_j, vjp = jax.vjp(jfn, v_j, x_j)
    gv_j, gx_j = vjp(jnp.asarray(cot).astype(jnp.float16))
    v_t.requires_grad_()
    x_t.requires_grad_()
    y_t = band.spmm_band_packed(v_t, radius, x_t) if packed else band.spmm_band(v_t, offs, x_t)
    y_t.float().backward(torch.from_numpy(cot))
    assert y_t.dtype == v_t.grad.dtype == x_t.grad.dtype == torch.float16
    assert y_j.dtype == gv_j.dtype == gx_j.dtype == jnp.float16
    for got, want in ((y_t, y_j), (v_t.grad, gv_j), (x_t.grad, gx_j)):
        _within_a_bf16_step(got, want, step=2.0 ** -10)


def test_mixed_dtype_gradients_match_jax(graphs):
    """bf16 x against f32 planes (tests/test_spmm_band.py:212): JAX returns
    dV in f32 (the values' dtype) and dX in bf16 (x's); so does the port,
    with the same values."""
    graph, _ = graphs
    rng = np.random.default_rng(2)
    x_t, x_j = _bf16(rng.normal(size=(N_PAD, 4)).astype(np.float32))

    def jloss(vals, xx):
        return jnp.sum(jax_band.spmm_band(vals, graph.offsets, xx, block=BLOCK).astype(jnp.float32))

    gv_j, gx_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(graph.band_values), x_j)
    v_t = torch.from_numpy(graph.band_values).requires_grad_()
    x_t.requires_grad_()
    band.spmm_band(v_t, graph.offsets, x_t).float().sum().backward()
    assert (v_t.grad.dtype, x_t.grad.dtype) == (torch.float32, torch.bfloat16)
    assert (gv_j.dtype, gx_j.dtype) == (jnp.float32, jnp.bfloat16)
    want = np.asarray(gv_j)
    np.testing.assert_allclose(v_t.grad.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    _within_a_bf16_step(x_t.grad, gx_j)


def test_pack_band_rows_keeps_the_dtype_and_packs_on_the_device(graphs):
    graph, _ = graphs
    offs = tuple(int(o) for o in graph.offsets)
    radius = band.band_radius(offs)
    want = band.pack_band_rows(graph.band_values, offs, radius)
    got = band.pack_band_rows(torch.from_numpy(graph.band_values).bfloat16(), offs, radius)
    assert got.dtype == torch.bfloat16 and want.dtype == np.float32
    np.testing.assert_array_equal(got.float().numpy(), torch.from_numpy(want).bfloat16().float().numpy())


# ----------------------------------------------------------- round_cotangent
def test_round_cotangent_is_the_identity_forward_and_casts_backward():
    """tests/test_precision.py's semantics: the forward returns x unchanged in
    its dtype; the cotangent comes back rounded to the given dtype (1/3 is no
    bf16 value), the same value as JAX's."""
    x = torch.arange(12.0).reshape(3, 4)
    y = round_cotangent(x, "bfloat16")
    assert y.dtype == torch.float32 and torch.equal(y, x)

    xb = torch.ones(4, dtype=torch.bfloat16, requires_grad=True)
    (round_cotangent(xb, torch.bfloat16).float() * (1.0 / 3.0)).sum().backward()

    def f(a):
        return jax_round_cotangent(a, "bfloat16").astype(jnp.float32) * (1.0 / 3.0)

    _, vjp = jax.vjp(f, jnp.ones((4,), jnp.bfloat16))
    (g,) = vjp(jnp.ones((4,), jnp.float32))
    assert xb.grad.dtype == torch.bfloat16 and g.dtype == jnp.bfloat16
    np.testing.assert_array_equal(xb.grad.float().numpy(), np.asarray(g, np.float32))


def test_round_cotangent_sits_at_the_two_sites_of_the_model(graphs, monkeypatch):
    """The per-step input stack (once per step and layer) and the
    layer-output stack (once per layer), as JAX places it, only under bf16."""
    from multistgraph_tpu_torch.models import sparse_atgcn as model_module

    calls = []

    def counting(x, dtype):
        calls.append(tuple(x.shape))
        return round_cotangent(x, dtype)

    monkeypatch.setattr(model_module, "round_cotangent", counting)
    cfg = _config()
    x = torch.zeros(B, T, N_PAD, 1)
    build_sparse_atgcn(graphs[0], cfg, device="cpu")(x)
    k = 2  # the identity and the band support
    assert calls == ([(k, N_PAD, B, 1)] * T + [(T, N_PAD, B, 8)] + [(k, N_PAD, B, 8)] * T + [(T, N_PAD, B, 8)])
    calls.clear()
    build_sparse_atgcn(graphs[0], dict(cfg, compute_dtype=None), device="cpu")(x)
    assert calls == []


# -------------------------------------------------------------------- model
def _config(**overrides):
    cfg = {"output_window": 3, "output_dim": 1, "rnn_units": 8, "num_layers": 2, "embed_dim_adj": 4,
           "adpadj": "none", "node_conditioned": "off", "embed_dim_node": 4, "remat": False,
           "compute_dtype": "bfloat16"}
    cfg.update(overrides)
    return cfg


@pytest.fixture(scope="module")
def jax_runs(graphs):
    """JAX's bf16 and f32 outputs and gradients of sum(out * cot) at the same
    seeded weights (its planes; the packed form is the same operator)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, T, N_PAD, 1)).astype(np.float32)
    cot = rng.normal(size=(B, 3, N_PAD, 1)).astype(np.float32)
    runs = {}
    for dtype in ("bfloat16", None):
        jmodel = jax_build(graphs[1], _config(compute_dtype=dtype), interpret=True)
        shapes = jax.eval_shape(lambda k, xx: jmodel.init(k, xx, train=False), jax.random.PRNGKey(0),
                                jnp.asarray(x))
        prng = np.random.default_rng(7)
        params = {k: (prng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in shapes["params"].items()}
        variables = jmodel.attach_graph({"params": params})

        def jloss(p, jmodel=jmodel, variables=variables):
            out = jmodel.apply({**variables, "params": p}, jnp.asarray(x), train=False)
            return jnp.sum(out * cot), out

        (loss, out), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
        runs[dtype] = (params, float(loss), np.asarray(out), {k: np.asarray(v) for k, v in grads.items()})
    return x, cot, runs


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("packed", [False, True], ids=["planes", "packed"])
def test_bf16_model_output_loss_and_gradients_match_jax(graphs, jax_runs, packed):
    x, cot, runs = jax_runs
    params, want_loss, want, grads = runs["bfloat16"]
    model = build_sparse_atgcn(graphs[0], _config(graph_band_packed=packed, remat=True), device="cpu")
    model.load_state_dict(state_dict_from_jax(params, model))
    out = model(torch.from_numpy(x), train=True)
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    assert out.dtype == torch.float32 and out.shape == (B, 3, N_PAD, 1)
    errs = {"output": _rel(out.detach().numpy(), want),
            "loss": abs(float(loss.detach()) - want_loss) / abs(want_loss)}
    named = dict(model.named_parameters())
    assert set(named) == set(grads)
    for name, g in grads.items():
        assert named[name].grad.dtype == torch.float32, name  # parameters and their gradients stay f32
        errs[name] = _rel(named[name].grad.numpy(), g)
    worst = max(errs, key=errs.get)
    assert errs[worst] < MODEL_BOUND, (worst, errs)
    # and it computes in bf16: JAX's f32 run is further away than f32 noise
    assert _rel(out.detach().numpy(), runs[None][2]) > 1e-3


def test_bf16_model_stores_its_graph_arrays_in_bf16(graphs):
    """As JAX's attach_graph (tests/test_sparse_model.py:302-319): the band
    planes or packed rows, the hub columns and the tail weights in bf16, the
    indices as they were; on planes and on packed rows."""
    for packed in (False, True):
        model = build_sparse_atgcn(graphs[0], _config(graph_band_packed=packed), device="cpu")
        dtypes = {n: b.dtype for n, b in model.named_buffers()}
        band_name = "support0_band_packed" if packed else "support0_band_values"
        assert {band_name, "support0_hub_values", "support0_tail_w"} <= set(dtypes)
        for name, dtype in dtypes.items():
            assert dtype == (torch.int32 if name.endswith(("_cols", "_src", "_dst")) else torch.bfloat16), name
        assert all(p.dtype == torch.float32 for p in model.parameters())


def test_unknown_compute_dtype_is_refused(graphs):
    """A name no dtype has: JAX's model fails on it too (its astype raises a
    TypeError at the first cast), where 'float64' would run silently as f32
    without x64 and 'float16' is a compute dtype of both packages."""
    with pytest.raises(ValueError, match="compute_dtype"):
        build_sparse_atgcn(graphs[0], _config(compute_dtype="float8"), device="cpu")


def test_run_model_cli_reaches_the_bf16_band_model(tmp_path, monkeypatch):
    """run_model --model SparseATGCN --graph_split band --adpadj none
    --compute_dtype bfloat16 builds the bf16 model and trains it."""
    from multistgraph_tpu_torch.models import sparse_atgcn as model_module

    built = []
    real = model_module.build_sparse_atgcn

    def recording(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(model_module, "build_sparse_atgcn", recording)
    argv = ["--model", "SparseATGCN", "--dataset", "SYN_LARGE_BF16", "--exp_id", "bf16",
            "--output_dir", str(tmp_path / "out"), "--num_nodes", "300", "--avg_degree", "8",
            "--len_time", "40", "--input_window", "3", "--output_window", "2", "--rnn_units", "4",
            "--num_layers", "1", "--batch_size", "4", "--graph_split", "band", "--adpadj", "none",
            "--compute_dtype", "bfloat16", "--config_file", "cfg", "--device", "cpu"]
    (tmp_path / "cfg.json").write_text('{"max_epoch": 1, "tensorboard": false}')
    monkeypatch.chdir(tmp_path)
    (metrics,) = run_model_cli.main(argv)
    assert built and built[0].compute_dtype == torch.bfloat16
    assert built[0].support0_band_values.dtype == torch.bfloat16
    assert all(np.isfinite(v).all() for k, v in metrics.items() if k != "MAPE")
    assert os.path.exists(tmp_path / "out" / "bf16" / "model_cache" / "SparseATGCN_SYN_LARGE_BF16.pt")
