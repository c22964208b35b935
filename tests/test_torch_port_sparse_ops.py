"""The port's block-sparse graph builders and kernels' plain versions against
the JAX package: BSR builders, both SpMM forms, the SDDMM, the block
transpose and both sparse softmaxes, forward and every gradient.

The JAX Pallas kernels run in interpret mode, as tests/test_spmm.py runs
them. Tolerances, each with its reason:
  * graph builders and row offsets: exact (the same numpy streams and the
    same np.add.at accumulation order);
  * products, forward and gradients: rtol 1e-5 with atol 1e-6 times the
    reference's max |value|: the same f32 products, summed in another
    order (a 128-long dot in one bmm against the interpreter's dot);
  * the block transpose: exact (a permutation).
The kernels themselves (csrc/bsr_spmm.cu, csrc/sampled_matmul.cu) run only
on the card: tests/test_torch_port_sparse_cuda.py holds them against these
plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multistgraph_tpu.ops import bsr as jax_bsr
from multistgraph_tpu.ops import spmm as jax_spmm
from multistgraph_tpu.ops.spmm_stream import row_ptr_from_rows as jax_row_ptr_from_rows
from multistgraph_tpu_torch.ops import bsr, spmm

BLOCK = 128
N_PAD = 3 * BLOCK  # row block 1 is left empty


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other CPU tests use beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_close(got, want, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _graph(seed=0, density=0.05):
    """A 3-block graph whose middle row block has no edge."""
    rng = np.random.default_rng(seed)
    dense = (rng.uniform(size=(N_PAD, N_PAD)) < density) * rng.normal(size=(N_PAD, N_PAD))
    dense[BLOCK: 2 * BLOCK] = 0.0
    g = bsr.bsr_from_dense(dense.astype(np.float32), block=BLOCK)
    assert 1 not in set(g.row_of.tolist())
    return g


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_graph(got, want):
    for name in ("values", "row_of", "col_of"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.num_nodes, got.block, got.padded_nodes) == (want.num_nodes, want.block, want.padded_nodes)


# ------------------------------------------------------------- builders
@pytest.mark.parametrize("native", [False, None], ids=["numpy", "default"])
def test_bsr_from_coo_equals_jax(native):
    rng = np.random.default_rng(4)
    n = 300
    src = rng.integers(0, n, 4000)
    dst = rng.integers(0, n, 4000)
    src[:3], dst[:3] = 7, 9  # duplicate edges accumulate
    w = rng.uniform(0.1, 1.0, 4000).astype(np.float32)
    _same_graph(bsr.bsr_from_coo(src, dst, w, n), jax_bsr.bsr_from_coo(src, dst, w, n, native=native))


def test_bsr_from_dense_equals_jax():
    rng = np.random.default_rng(5)
    dense = ((rng.uniform(size=(300, 300)) < 0.01) * rng.normal(size=(300, 300))).astype(np.float32)
    got, want = bsr.bsr_from_dense(dense), jax_bsr.bsr_from_dense(dense)
    _same_graph(got, want)
    np.testing.assert_array_equal(got.to_dense(), dense)


@pytest.mark.parametrize("num_nodes,degree,seed", [(200, 8, 0), (1000, 16, 3), (4096, 16, 0)])
def test_random_spatial_graph_equals_jax(num_nodes, degree, seed):
    got, edges = bsr.random_spatial_graph(num_nodes, degree, seed=seed)
    want, want_edges = jax_bsr.random_spatial_graph(num_nodes, degree, seed=seed)
    assert edges == want_edges
    _same_graph(got, want)
    nb = got.num_row_blocks
    np.testing.assert_array_equal(bsr.row_ptr_from_rows(got.row_of, nb), jax_row_ptr_from_rows(want.row_of, nb))
    np.testing.assert_array_equal(spmm.row_ptr_of(_t(got.row_of), nb).numpy(), bsr.row_ptr_from_rows(got.row_of, nb))
    if num_nodes == 4096:  # the dataset's default size: 373 tiles in 32 row blocks
        assert (got.nnz_blocks, nb) == (373, 32)


def test_random_powerlaw_graph_equals_jax():
    got, edges = bsr.random_powerlaw_graph(1024, avg_degree=8, seed=1)
    want, want_edges = jax_bsr.random_powerlaw_graph(1024, avg_degree=8, seed=1)
    assert edges == want_edges
    _same_graph(got, want)


def test_unported_graph_forms_raise():
    """The split forms that raised until they were ported are now built, as
    JAX's types of the same edges with JAX's padding
    (tests/test_torch_port_band_ops.py holds their arrays equal)."""
    for split in ("hub", "tail", "band"):
        got = bsr.random_spatial_graph(200, 8, split=split)[0]
        assert type(got).__name__ == type(jax_bsr.random_spatial_graph(200, 8, split=split)[0]).__name__
        assert got.padded_nodes == 256
    _same_graph(bsr.random_spatial_graph(200, 8, split="none")[0], bsr.random_spatial_graph(200, 8)[0])


# ------------------------------------------------------------- products
def _vjp_inputs(g, feat, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g.padded_nodes, feat)).astype(np.float32)
    dy = rng.normal(size=(g.padded_nodes, feat)).astype(np.float32)
    return x, dy


def _hub_graph(n_blocks=spmm.SEGMENT_TILES + 4, seed=4):
    """A graph whose column block 0 is a hub, with edges into it from every
    row block but row block 1 (which has no edge), beside random edges in
    the diagonal tiles: its block transpose holds a row of n_blocks - 1
    tiles, more than one bsr_spmm segment."""
    rng = np.random.default_rng(seed)
    n = n_blocks * BLOCK
    rows = np.setdiff1d(np.arange(n), np.arange(BLOCK, 2 * BLOCK))   # no edge out of row block 1
    src = rng.choice(rows, size=80 * n_blocks)
    diagonal = src[40 * n_blocks:] // BLOCK * BLOCK + rng.integers(0, BLOCK, size=40 * n_blocks)
    dst = np.concatenate([rng.integers(0, BLOCK, size=40 * n_blocks), diagonal])
    g = bsr.bsr_from_coo(src, dst, rng.normal(size=len(src)).astype(np.float32), n, block=BLOCK)
    assert int((g.col_of == 0).sum()) == n_blocks - 1 > spmm.SEGMENT_TILES
    return g


@pytest.mark.parametrize("feat,hub", [(3, False), (24, False), (128, False), (24, True)],
                         ids=["3", "24", "128", "hub-24"])
@pytest.mark.parametrize("pret", [False, True], ids=["spmm", "spmm_pret"])
def test_spmm_forward_and_gradients_match_jax(feat, hub, pret):
    """Forward, dX and dA against JAX. The hub case's transposed graph has
    a row longer than one segment: on the CPU it checks that the plan and
    the pattern reach the backward's dX as they should (bsr_spmm takes its
    plain version here); the segment split itself is held against the plain
    version on the card (tests/test_torch_port_sparse_cuda.py)."""
    g = _hub_graph() if hub else _graph()
    x, dy = _vjp_inputs(g, feat)
    nb = g.num_row_blocks

    def jax_fn(v, xx):
        if pret:
            pre = jax_spmm.bsr_transpose(v, g.row_of, g.col_of, nb)
            return jax_spmm.spmm_pret(v, jax.lax.stop_gradient(pre), g.row_of, g.col_of, xx, interpret=True)
        return jax_spmm.spmm(v, g.row_of, g.col_of, xx, interpret=True)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(g.values), jnp.asarray(x))
    want_dv, want_dx = vjp(jnp.asarray(dy))

    values = _t(g.values).requires_grad_()
    xt = _t(x).requires_grad_()
    row, col = _t(g.row_of), _t(g.col_of)
    if pret:
        y = spmm.spmm_pret(values, spmm.bsr_transpose_plan(values.detach(), row, col, nb), row, col, xt)
    else:
        y = spmm.spmm(values, row, col, xt)
    y.backward(_t(dy))
    _assert_close(y, want, "y")
    assert not y[BLOCK: 2 * BLOCK].any()  # the empty row block
    _assert_close(xt.grad, want_dx, "dx")
    _assert_close(values.grad, want_dv, "dvalues")


def test_spmm_skips_the_gradient_terms_nobody_needs():
    """dA of a constant support and dX of a constant input are never formed."""
    g = _graph()
    x, dy = _vjp_inputs(g, 24)
    row, col = _t(g.row_of), _t(g.col_of)
    calls = {"spmm": 0, "sampled": 0}
    real_spmm, real_sampled = spmm.bsr_spmm, spmm.sampled_matmul

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spmm, "bsr_spmm", count("spmm", real_spmm))
        mp.setattr(spmm, "sampled_matmul", count("sampled", real_sampled))
        spmm.spmm(_t(g.values), row, col, _t(x).requires_grad_()).backward(_t(dy))
        assert calls == {"spmm": 2, "sampled": 0}
        spmm.spmm(_t(g.values).requires_grad_(), row, col, _t(x)).backward(_t(dy))
        assert calls == {"spmm": 3, "sampled": 1}
        with torch.no_grad():
            spmm.spmm(_t(g.values).requires_grad_(), row, col, _t(x).requires_grad_())
        assert calls == {"spmm": 4, "sampled": 1}


@pytest.mark.parametrize("d", [3, 16, 128])
def test_sampled_matmul_plain_matches_jax(d):
    g = _graph()
    rng = np.random.default_rng(2)
    a = rng.normal(size=(N_PAD, d)).astype(np.float32)
    bt = rng.normal(size=(N_PAD, d)).astype(np.float32)
    want = jax_spmm._sampled_matmul_impl(jnp.asarray(a), jnp.asarray(bt.T), jnp.asarray(g.row_of),
                                         jnp.asarray(g.col_of), block=BLOCK, interpret=True)
    _assert_close(spmm.sampled_matmul(_t(a), _t(bt), _t(g.row_of), _t(g.col_of)), want)


@pytest.mark.parametrize("d", [3, 16])
def test_sddmm_relu_forward_and_gradients_match_jax(d):
    g = _graph(seed=3)
    rng = np.random.default_rng(6)
    e1 = rng.normal(size=(N_PAD, d)).astype(np.float32)
    e2 = rng.normal(size=(d, N_PAD)).astype(np.float32)
    ds = rng.normal(size=g.values.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: jax_spmm.sddmm_relu(a, b, g.row_of, g.col_of, interpret=True),
                        jnp.asarray(e1), jnp.asarray(e2))
    want_de1, want_de2 = vjp(jnp.asarray(ds))
    t1, t2 = _t(e1).requires_grad_(), _t(e2).requires_grad_()
    got = spmm.sddmm_relu(t1, t2, _t(g.row_of), _t(g.col_of))
    got.backward(_t(ds))
    _assert_close(got, want, "scores")
    assert (got > 0).any() and (got == 0).any()  # both sides of the relu
    _assert_close(t1.grad, want_de1, "de1")
    _assert_close(t2.grad, want_de2, "de2")


def test_bsr_transpose_equals_jax():
    g = _graph()
    nb = g.num_row_blocks
    got = spmm.bsr_transpose(_t(g.values), _t(g.row_of), _t(g.col_of), nb)
    want = jax_spmm.bsr_transpose(jnp.asarray(g.values), jnp.asarray(g.row_of), jnp.asarray(g.col_of), nb)
    assert got[0].is_contiguous()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", ["sampled", "dense_corrected"])
def test_sparse_softmaxes_and_gradients_match_jax(kind):
    g = _graph(seed=7)
    nb = g.num_row_blocks
    rng = np.random.default_rng(8)
    scores = np.maximum(rng.normal(size=g.values.shape), 0).astype(np.float32)
    cots = [rng.normal(size=g.values.shape).astype(np.float32), rng.normal(size=(nb, BLOCK)).astype(np.float32)]
    if kind == "sampled":
        jfn = lambda v: (jax_spmm.sparse_row_softmax(v, g.row_of, nb),)  # noqa: E731
        tfn = lambda v: (spmm.sparse_row_softmax(v, _t(g.row_of), nb),)  # noqa: E731
    else:
        jfn = lambda v: jax_spmm.sparse_row_softmax_dense_corrected(v, g.row_of, nb, N_PAD)  # noqa: E731
        tfn = lambda v: spmm.sparse_row_softmax_dense_corrected(v, _t(g.row_of), nb, N_PAD)  # noqa: E731
    want, vjp = jax.vjp(jfn, jnp.asarray(scores))
    (want_dv,) = vjp(tuple(jnp.asarray(c) for c in cots[: len(want)]))
    v = _t(scores).requires_grad_()
    got = tfn(v)
    torch.autograd.backward(got, [_t(c) for c in cots[: len(got)]])
    for a, b in zip(got, want):
        _assert_close(a, b, kind)
    _assert_close(v.grad, want_dv, "dscores")


def test_wrappers_reject_what_the_kernels_do_not_take():
    g = _graph()
    row, col = _t(g.row_of), _t(g.col_of)
    ptr = spmm.row_ptr_of(row, g.num_row_blocks)
    x = torch.zeros(N_PAD, 8)
    with pytest.raises(TypeError, match="float32"):
        spmm.bsr_spmm(_t(g.values).double(), row, ptr, col, x, g.num_row_blocks)
    with pytest.raises(TypeError, match="int32"):
        spmm.bsr_spmm(_t(g.values), row.long(), ptr, col, x, g.num_row_blocks)
    with pytest.raises(ValueError, match="contiguous"):
        spmm.bsr_spmm(_t(g.values), row, ptr, col, torch.zeros(8, N_PAD).t(), g.num_row_blocks)
    with pytest.raises(ValueError, match="shape mismatch"):
        spmm.bsr_spmm(_t(g.values), row, ptr, col, x, g.num_row_blocks + 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        spmm.sampled_matmul(torch.zeros(N_PAD, 4), torch.zeros(N_PAD, 5), row, col)
    with pytest.raises(ValueError, match="contiguous"):
        spmm.sampled_matmul(torch.zeros(4, N_PAD).t(), torch.zeros(N_PAD, 4), row, col)
