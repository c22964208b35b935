"""The port's bf16 BSR path against the JAX package: ``spmm`` (with and
without a precomputed transpose), ``sampled_matmul``, ``sddmm_relu`` and
both sparse softmaxes in bf16, forward and gradients, and SparseATGCN with
``compute_dtype='bfloat16'`` and the adaptive view on the BSR, hub, tail and
band forms, on the same numpy inputs.

The JAX Pallas kernels run in interpret mode, as tests/test_spmm.py runs
them; its bf16 model runs jitted, as its executor runs it. Tolerances, each
with its reason:
  * SpMM outputs, f32 for bf16 operands: rtol 1e-5 with atol 1e-5 times
    max |JAX| (both sum the same exact products of bf16 values in f32, in
    another order);
  * bf16 results (dV, dX, the SDDMM's scores, dE1 and dE2): within one
    bf16 step of JAX, 2^-7 |JAX| + 2^-7 * 1e-3 max|JAX| (the same f32 sums
    in another order, rounded once: they may round to neighbouring bf16
    values);
  * the softmaxes' values: within two bf16 steps (XLA fuses exp into the
    division and rounds once, PyTorch rounds exp to bf16 first: one more
    rounding); the dense-corrected background, 1/Z from f32 row sums
    rounded once: one bf16 step;
  * the model, relative max errors (max |port - JAX| over max |JAX|): the
    output and the loss below 3e-2, the bound of the band's bf16 model test
    (test_torch_port_band_bf16.py; readings 1.4e-2); every gradient below
    0.1 (readings up to 7.1e-2, node_vec1's on the hub and band forms; the
    other gradients up to 3.1e-2). The adaptive embeddings' gradients sum
    the sparse softmax's gradient terms, which cancel, and XLA's CPU
    reduces that gradient's bf16 tile rows in bf16 (a bf16 `reduce` in
    its HLO), where PyTorch sums them in f32 and rounds once: each side's
    bf16 noise, about 3-5e-2 against the f32 function on these inputs,
    adds up. So the test also asks that the port's bf16 run be no further
    from the f32 function than 1.5 times JAX's own bf16 run is (readings
    0.79-1.27).
The kernels themselves run only on the card:
tests/test_torch_port_sparse_bf16_cuda.py holds them against these plain
versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multistgraph_tpu.models.sparse_atgcn import build_sparse_atgcn as jax_build
from multistgraph_tpu.ops import bsr as jax_bsr
from multistgraph_tpu.ops import spmm as jax_spmm
from multistgraph_tpu_torch.models.sparse_atgcn import build_sparse_atgcn
from multistgraph_tpu_torch.ops import bsr, spmm
from multistgraph_tpu_torch.utils.jax_import import state_dict_from_jax

BLOCK = 128
N_PAD = 3 * BLOCK  # the op tests' graph: row block 1 is left empty
NODES, N_MODEL, B, T = 600, 640, 2, 4  # the model tests' graph: 600 nodes padded to 5 row blocks
MODEL_BOUND = 3e-2
GRAD_BOUND = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other CPU tests use beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graph(seed=0, density=0.05):
    """A 3-block graph whose middle row block has no edge, its tiles in bf16."""
    rng = np.random.default_rng(seed)
    dense = (rng.uniform(size=(N_PAD, N_PAD)) < density) * rng.normal(size=(N_PAD, N_PAD))
    dense[BLOCK: 2 * BLOCK] = 0.0
    return bsr.bsr_from_dense(dense.astype(np.float32), block=BLOCK)


def _bf16(a):
    """numpy f32 -> (torch bf16, jnp bf16) holding the same values."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(jnp.asarray(a, jnp.float32))


def _f32_close(got, want):
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _within_bf16_steps(got, want, steps=1):
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got, want = _np(got), _np(want)
    bound = steps * 2.0 ** -7 * (np.abs(want) + 1e-3 * np.abs(want).max())
    assert (np.abs(got - want) <= bound).all(), float((np.abs(got - want) / bound).max())


# ------------------------------------------------------------------- ops
@pytest.mark.parametrize("feat", [3, 24, 128])
@pytest.mark.parametrize("pret", [False, True], ids=["spmm", "spmm_pret"])
def test_bf16_spmm_forward_and_gradients_match_jax(feat, pret):
    """f32 sums of bf16 operands (JAX's kernels return f32); dY rounded to
    bf16 once, dX and dV in bf16 (the primals' dtype)."""
    g = _graph()
    nb = g.num_row_blocks
    rng = np.random.default_rng(1)
    v_t, v_j = _bf16(g.values)
    x_t, x_j = _bf16(rng.normal(size=(N_PAD, feat)))
    dy = rng.normal(size=(N_PAD, feat)).astype(np.float32)

    def jax_fn(v, xx):
        if pret:
            pre = jax_spmm.bsr_transpose(v, g.row_of, g.col_of, nb)
            return jax_spmm.spmm_pret(v, jax.lax.stop_gradient(pre), g.row_of, g.col_of, xx, interpret=True)
        return jax_spmm.spmm(v, g.row_of, g.col_of, xx, interpret=True)

    want, vjp = jax.vjp(jax_fn, v_j, x_j)
    want_dv, want_dx = vjp(jnp.asarray(dy))
    values, xt = v_t.requires_grad_(), x_t.requires_grad_()
    row, col = _t(g.row_of), _t(g.col_of)
    if pret:
        y = spmm.spmm_pret(values, spmm.bsr_transpose_plan(values.detach(), row, col, nb), row, col, xt)
    else:
        y = spmm.spmm(values, row, col, xt)
    y.backward(_t(dy))
    _f32_close(y, want)
    assert not y[BLOCK: 2 * BLOCK].any()  # the empty row block
    _within_bf16_steps(xt.grad, want_dx)
    _within_bf16_steps(values.grad, want_dv)


@pytest.mark.parametrize("d", [3, 16, 24])
def test_bf16_sampled_matmul_matches_jax(d):
    """bf16 tiles, the f32 sums rounded once (JAX spmm.py:122-128)."""
    g = _graph()
    rng = np.random.default_rng(2)
    a_t, a_j = _bf16(rng.normal(size=(N_PAD, d)))
    b_t, b_j = _bf16(rng.normal(size=(N_PAD, d)))
    want = jax_spmm._sampled_matmul_impl(a_j, b_j.T, jnp.asarray(g.row_of), jnp.asarray(g.col_of), block=BLOCK,
                                         interpret=True)
    _within_bf16_steps(spmm.sampled_matmul(a_t, b_t, _t(g.row_of), _t(g.col_of)), want)


@pytest.mark.parametrize("d", [16, 24])
def test_bf16_sddmm_relu_forward_and_gradients_match_jax(d):
    g = _graph(seed=3)
    rng = np.random.default_rng(4)
    e1_t, e1_j = _bf16(rng.normal(size=(N_PAD, d)) * 0.3)
    e2_t, e2_j = _bf16(rng.normal(size=(d, N_PAD)) * 0.3)
    ds_t, ds_j = _bf16(rng.normal(size=(g.nnz_blocks, BLOCK, BLOCK)))
    want, vjp = jax.vjp(lambda a, b: jax_spmm.sddmm_relu(a, b, g.row_of, g.col_of, interpret=True), e1_j, e2_j)
    want_de1, want_de2 = vjp(ds_j)
    e1, e2 = e1_t.requires_grad_(), e2_t.requires_grad_()
    s = spmm.sddmm_relu(e1, e2, _t(g.row_of), _t(g.col_of))
    s.backward(ds_t)
    _within_bf16_steps(s, want)
    _within_bf16_steps(e1.grad, want_de1)
    _within_bf16_steps(e2.grad, want_de2)


@pytest.mark.parametrize("kind", ["sampled", "dense_corrected"])
def test_bf16_softmaxes_match_jax(kind):
    """bf16 values from bf16 scores, the row sums in f32 (JAX
    spmm.py:327-331, 350-353); the dense-corrected background in bf16."""
    g = _graph(seed=5)
    rng = np.random.default_rng(6)
    s_t, s_j = _bf16(np.maximum(rng.normal(size=(g.nnz_blocks, BLOCK, BLOCK)), 0.0) * 2.0)
    nb = g.num_row_blocks
    row_t, row_j = _t(g.row_of), jnp.asarray(g.row_of)
    if kind == "sampled":
        got = spmm.sparse_row_softmax(s_t, row_t, nb)
        want = jax_spmm.sparse_row_softmax(s_j, row_j, nb)
    else:
        got, background = spmm.sparse_row_softmax_dense_corrected(s_t, row_t, nb, N_PAD)
        want, want_background = jax_spmm.sparse_row_softmax_dense_corrected(s_j, row_j, nb, N_PAD)
        _within_bf16_steps(background, want_background)
    _within_bf16_steps(got, want, steps=2)


def test_f32_softmaxes_are_unchanged_by_the_f32_row_sums():
    """The f32 path's row sums were f32 before: the same values bit for bit
    as the plain f32 formula."""
    g = _graph(seed=5)
    rng = np.random.default_rng(7)
    s = _t(np.maximum(rng.normal(size=(g.nnz_blocks, BLOCK, BLOCK)), 0.0).astype(np.float32))
    row, nb = _t(g.row_of), g.num_row_blocks
    exp_vals = torch.where(s > 0, torch.exp(s), 0.0)
    totals = torch.zeros(nb, BLOCK).index_add(0, row, exp_vals.sum(dim=2))
    want = exp_vals / totals.index_select(0, row).clamp_min(1e-9)[:, :, None]
    assert torch.equal(spmm.sparse_row_softmax(s, row, nb), want)


def test_planted_fault_is_scoped_and_leaves_the_cpu_path_alone():
    """planted_fault reaches only the named kernel, only inside its block, and
    the plain versions never read it."""
    g = _graph()
    x, _ = _bf16(np.random.default_rng(8).normal(size=(N_PAD, 16)))
    row, col = _t(g.row_of), _t(g.col_of)
    values, _ = _bf16(g.values)
    want = spmm.bsr_spmm(values, row, spmm.row_ptr_of(row, 3), col, x, 3)
    with spmm.planted_fault("k16", "bsr_spmm"):
        assert spmm._planted == {"bsr_spmm": 1}
        assert torch.equal(spmm.bsr_spmm(values, row, spmm.row_ptr_of(row, 3), col, x, 3), want)
    with spmm.planted_fault("row"):
        assert spmm._planted == {"bsr_spmm": 3, "sampled_matmul": 3}
    assert spmm._planted == {}
    with pytest.raises(ValueError, match="planted_fault takes a kernel"):
        with spmm.planted_fault("tile", "band_spmm"):
            pass
    assert [spmm.bf16_load_path(f) for f in (12, 16, 24, 1)] == ["element loads", "TMA", "TMA", "element loads"]


# ------------------------------------------------------------------ model
def _config(**overrides):
    cfg = {"output_window": 3, "output_dim": 1, "rnn_units": 8, "num_layers": 2, "embed_dim_adj": 4,
           "adpadj": "unidirection", "node_conditioned": "off", "embed_dim_node": 4, "remat": True,
           "compute_dtype": "bfloat16"}
    cfg.update(overrides)
    return cfg


FORMS = {"bsr": None, "hub": "hub", "tail": "tail", "band+adaptive": "band"}


def _graphs(form):
    """The same synthetic spatial graph in the port's and in JAX's form."""
    return (bsr.random_spatial_graph(NODES, 8, seed=2, split=FORMS[form])[0],
            jax_bsr.random_spatial_graph(NODES, 8, seed=2, split=FORMS[form])[0])


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    return (rng.normal(size=(B, T, N_MODEL, 1)).astype(np.float32),
            rng.normal(size=(B, 3, N_MODEL, 1)).astype(np.float32))


def _jax_run(graph, x, cot):
    """JAX's bf16 model at seeded random weights: its output, the loss
    sum(out * cot) and every gradient, jitted."""
    jmodel = jax_build(graph, _config(), interpret=True)
    shapes = jax.eval_shape(lambda k, xx: jmodel.init(k, xx, train=False), jax.random.PRNGKey(0), jnp.asarray(x))
    prng = np.random.default_rng(7)
    params = {k: (prng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in shapes["params"].items()}
    variables = jmodel.attach_graph({"params": params})

    def jloss(p):
        out = jmodel.apply({**variables, "params": p}, jnp.asarray(x), train=False)
        return jnp.sum(out * cot), out

    (loss, out), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    return params, float(loss), np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


def _port_run(graph, params, x, cot, compute_dtype):
    """The port's model at JAX's weights: output, loss and every gradient."""
    model = build_sparse_atgcn(graph, _config(compute_dtype=compute_dtype), device="cpu")
    model.load_state_dict(state_dict_from_jax(params, model))
    out = model(torch.from_numpy(x), train=True)
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    assert out.dtype == torch.float32 and out.shape == (B, 3, N_MODEL, 1)
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())  # parameters and gradients stay f32
    return out.detach().numpy(), float(loss.detach()), {n: p.grad.numpy() for n, p in model.named_parameters()}


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("form", sorted(FORMS))
def test_bf16_model_output_loss_and_gradients_match_jax(inputs, form):
    """SparseATGCN in bf16 with the adaptive view (sampled softmax, remat),
    loaded with JAX's weights through state_dict_from_jax, against JAX's
    bf16 model:
      * the output within MODEL_BOUND, and the loss within MODEL_BOUND of
        the sum of |out * cot| it adds up (its own value cancels);
      * every gradient within GRAD_BOUND;
      * as accurate as JAX's bf16 run: the largest error of the output and
        of any gradient against the port's f32 run (JAX's f32 function to
        1e-5, test_torch_port_sparse_model.py) at most 1.5 times JAX's own;
      * and it computes in bf16: over 1e-3 from the f32 run."""
    graph, jgraph = _graphs(form)
    x, cot = inputs
    params, want_loss, want, grads = _jax_run(jgraph, x, cot)
    out, loss, got = _port_run(graph, params, x, cot, "bfloat16")
    out32, _, got32 = _port_run(graph, params, x, cot, None)
    assert set(got) == set(grads) and "node_vec1" in got
    assert _rel(out, want) < MODEL_BOUND
    assert abs(loss - want_loss) / np.abs(want * cot).sum() < MODEL_BOUND
    errs = {name: _rel(got[name], g) for name, g in grads.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_BOUND, (worst, errs)
    port_err = max([_rel(out, out32)] + [_rel(got[n], got32[n]) for n in grads])
    jax_err = max([_rel(want, out32)] + [_rel(grads[n], got32[n]) for n in grads])
    assert port_err <= 1.5 * jax_err, (port_err, jax_err)
    assert _rel(out, out32) > 1e-3


@pytest.mark.parametrize("form", ["bsr", "hub", "tail"])
def test_bf16_model_stores_its_graph_arrays_in_bf16(form):
    """As JAX's attach_graph casts them (sparse_atgcn.py:212-222): the BSR
    tiles, the hub columns and the tail weights in bf16, every index array
    (tiles' rows, columns and offsets, hub columns, tail ends, the adaptive
    pattern) in int32; parameters in f32."""
    model = build_sparse_atgcn(_graphs(form)[0], _config(), device="cpu")
    dtypes = {n: b.dtype for n, b in model.named_buffers()}
    floats = {"bsr": {"support0_values"}, "hub": {"support0_values", "support0_hub_values"},
              "tail": {"support0_values", "support0_tail_w"}}[form]
    assert floats <= set(dtypes) and {"adaptive_row", "adaptive_col", "adaptive_row_ptr"} <= set(dtypes)
    for name, dtype in dtypes.items():
        assert dtype == (torch.bfloat16 if name in floats else torch.int32), name
    assert all(p.dtype == torch.float32 for p in model.parameters())
