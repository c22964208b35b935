"""Kernels B2 (int8 node apply), B2t (its transpose) and B3 (layout copy,
forward and backward) of the port.

On the CPU the wrappers take their plain versions, which are held against
the JAX package (the Pallas kernels in interpret mode). B2t's tolerance is
one bf16 step: both sides take the same bf16-rounded products, exact in
f32, and only the order of the f32 sums differs, which can move the final
rounding to bf16 by one step (at most 2^-7 of the value). The tests marked
``cuda`` hold each CUDA kernel against its plain version on the card and
skip without one; they import no JAX, so the file runs on a machine without
it:  python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_node_apply.py
"""

import numpy as np
import pytest
import torch

from multistgraph_tpu_torch.ops.layout import force_default_layout, force_default_layout_plain
from multistgraph_tpu_torch.ops.node_apply import (
    _pad_nodes,
    node_apply_q8,
    node_apply_q8_plain,
    node_apply_q8_t,
    node_apply_q8_t_plain,
    quantize_node_weights,
)

N, B, KI, O = 37, 4, 24, 16  # N is not a multiple of the 32-node block


def _weights(seed=0, shape=(N, KI, O)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 0.2


def _jnp():
    import jax.numpy as jnp

    return jnp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax_exactly(dtype):
    jnp = _jnp()
    from multistgraph_tpu.ops.node_apply import quantize_node_weights as jax_quantize

    w = _weights()
    wj = jnp.asarray(w).astype(dtype)
    qj, sj = jax_quantize(wj)
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(getattr(torch, dtype))
    qt, st = quantize_node_weights(wt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_plain_apply_matches_jax_interpret():
    jnp = _jnp()
    from multistgraph_tpu.ops.node_apply import node_apply_q8 as jax_apply

    rng = np.random.default_rng(1)
    hh = rng.normal(size=(N, B, KI)).astype(np.float32)
    hh_j = jnp.asarray(hh).astype(jnp.bfloat16)
    wq, s = quantize_node_weights(torch.from_numpy(_weights()))
    want = np.asarray(jax_apply(hh_j, jnp.asarray(wq.numpy()), jnp.asarray(s.numpy()), interpret=True))
    hh_t = torch.from_numpy(np.array(hh_j.astype(jnp.float32))).to(torch.bfloat16)
    got = node_apply_q8(hh_t, wq, s)
    assert got.dtype == torch.float32 and got.shape == (N, B, O)
    # the same products; only the summation order differs
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # padded weight rows (the model pads N to a 32-node block) are ignored
    padded = node_apply_q8(hh_t, _pad_nodes(wq, 0, 64), _pad_nodes(s, 0, 64))
    np.testing.assert_array_equal(padded.numpy(), got.numpy())


def _assert_within_one_bf16_step(got, want):
    """|got - want| <= 2^-7 |want| elementwise (one bf16 step: 8 significant
    bits, so a step is 2^-8 to 2^-7 of the value), plus a floor for sums that
    cancel to ~0."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = 2.0 ** -7 * np.abs(want) + 2.0 ** -7 * 1e-3 * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), float(np.abs(got - want).max())


@pytest.mark.parametrize("b", [1, 3, 17])
def test_plain_transposed_apply_matches_jax_interpret(b):
    jnp = _jnp()
    from multistgraph_tpu.ops.node_apply import node_apply_q8_t as jax_apply_t

    rng = np.random.default_rng(b)
    dpre = rng.normal(size=(N, b, O)).astype(np.float32)
    dpre_j = jnp.asarray(dpre).astype(jnp.bfloat16)
    wq, s = quantize_node_weights(torch.from_numpy(_weights(seed=b)))
    # the model pads N to a multiple of 32 (37 -> 64); pad rows are ignored
    wq, s = _pad_nodes(wq, 0, 64), _pad_nodes(s, 0, 64)
    want = jax_apply_t(dpre_j, jnp.asarray(wq.numpy()), jnp.asarray(s.numpy()), interpret=True)
    assert want.dtype == jnp.bfloat16
    dpre_t = torch.from_numpy(np.array(dpre_j.astype(jnp.float32))).to(torch.bfloat16)
    got = node_apply_q8_t(dpre_t, wq, s)
    assert got.dtype == torch.bfloat16 and got.shape == (N, b, KI)
    _assert_within_one_bf16_step(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_layout_gradient_matches_the_jax_vjp_bit_for_bit():
    """The cotangent through force_default_layout of a strided view is the
    same copy as JAX's VJP (layout.py:56-64, interpret mode)."""
    jax = pytest.importorskip("jax")
    from multistgraph_tpu.ops.layout import force_default_layout as jax_layout

    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 2, 5, 12)).astype(np.float32)
    g = rng.normal(size=(3, 2, 5, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_layout(a[..., 4:], True), x)
    (want,) = vjp(g)
    xt = torch.tensor(x, requires_grad=True)
    y = force_default_layout(xt[..., 4:])
    assert y.is_contiguous()
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


def test_layout_plain_is_a_bit_identical_contiguous_copy():
    x = torch.randn(3, 4, 5, 12)
    for view in (x[..., :8], x[..., 8:], x.transpose(1, 2), x):
        y = force_default_layout(view)
        assert y.is_contiguous() and y.data_ptr() != view.data_ptr()
        assert torch.equal(y, view)


def test_wrappers_reject_wrong_dtypes_and_layouts():
    hh = torch.zeros(N, B, KI, dtype=torch.bfloat16)
    wq, s = quantize_node_weights(torch.from_numpy(_weights()))
    with pytest.raises(TypeError):
        node_apply_q8(hh.float(), wq, s)
    with pytest.raises(TypeError):
        node_apply_q8(hh, wq.float(), s)
    with pytest.raises(TypeError):
        node_apply_q8(hh, wq, s.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        node_apply_q8(hh.transpose(0, 1).contiguous().transpose(0, 1), wq, s)
    with pytest.raises(ValueError, match="shape"):
        node_apply_q8(hh[:, :, :-1].contiguous(), wq, s)
    with pytest.raises(ValueError, match="rank"):
        force_default_layout(torch.zeros(1, 1, 1, 1, 1))
    for dtype in (torch.bfloat16, torch.int8, torch.float64):
        with pytest.raises(TypeError, match="4-byte"):
            force_default_layout(torch.zeros(2, 3, dtype=dtype))
    dpre = torch.zeros(N, B, O, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        node_apply_q8_t(dpre.float(), wq, s)
    with pytest.raises(ValueError, match="shape"):
        node_apply_q8_t(dpre[:, :, :-1].contiguous(), wq, s)
    with pytest.raises(ValueError, match="contiguous"):
        node_apply_q8_t(dpre.transpose(0, 1).contiguous().transpose(0, 1), wq, s)
    with pytest.raises(ValueError, match="contraction"):
        node_apply_q8_t(torch.zeros(1, 1, 4096, dtype=torch.bfloat16),
                        torch.zeros(1, 8, 4096, dtype=torch.int8), torch.ones(1, 1, 4096))
    # the layout copy's backward takes 4-byte cotangents only, as the forward
    # (autograd hands it the forward's dtype, f32 on the main path)
    from multistgraph_tpu_torch.ops.layout import _ForceDefaultLayout

    with pytest.raises(TypeError, match="4-byte"):
        _ForceDefaultLayout.backward(None, torch.zeros(2, 3, dtype=torch.bfloat16))


# ---------------------------------------------------------------- on the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,o", [(16, 128), (16, 64), (3, 40), (33, 16)])
def test_cuda_node_apply_matches_plain(cuda, b, o):
    g = torch.Generator().manual_seed(b * o)
    n, ki = 237, 320
    hh = torch.randn(n, b, ki, generator=g).to(torch.bfloat16).to(cuda)
    wq, s = quantize_node_weights(torch.randn(n, ki, o, generator=g).to(cuda))
    wq, s = _pad_nodes(wq, 0, 256), _pad_nodes(s, 0, 256)
    before = node_apply_q8.launches
    got = node_apply_q8(hh, wq, s)
    torch.cuda.synchronize()
    assert node_apply_q8.launches == before + 1
    want = node_apply_q8_plain(hh, wq, s)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 256])
def test_cuda_node_apply_takes_any_batch(cuda, b):
    """B=256 was refused before the kernel walked the batch in tiles."""
    g = torch.Generator().manual_seed(b)
    n, ki = 237, 320
    for o in (128, 64):
        hh = torch.randn(n, b, ki, generator=g).to(torch.bfloat16).to(cuda)
        wq, s = quantize_node_weights(torch.randn(n, ki, o, generator=g).to(cuda))
        wq, s = _pad_nodes(wq, 0, 256), _pad_nodes(s, 0, 256)
        got = node_apply_q8(hh, wq, s)
        want = node_apply_q8_plain(hh, wq, s)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,o", [(16, 128), (16, 64), (1, 128), (256, 64), (33, 40)])
def test_cuda_transposed_node_apply_matches_plain(cuda, b, o):
    g = torch.Generator().manual_seed(b * o + 1)
    n, ki = 237, 320
    dpre = torch.randn(n, b, o, generator=g).to(torch.bfloat16).to(cuda)
    wq, s = quantize_node_weights(torch.randn(n, ki, o, generator=g).to(cuda))
    wq, s = _pad_nodes(wq, 0, 256), _pad_nodes(s, 0, 256)
    before = node_apply_q8_t.launches
    got = node_apply_q8_t(dpre, wq, s)
    torch.cuda.synchronize()
    assert node_apply_q8_t.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (n, b, ki)
    _assert_within_one_bf16_step(got.float().cpu().numpy(),
                                 node_apply_q8_t_plain(dpre, wq, s).float().cpu().numpy())


@pytest.mark.cuda
def test_cuda_layout_copy_backward_matches_plain(cuda):
    x = torch.randn(6, 5, 37, 192, device=cuda, requires_grad=True)
    cot = torch.randn(6, 5, 37, 128, device=cuda)
    before = (force_default_layout.launches, force_default_layout.backward_launches)
    y = force_default_layout(x[..., :128])
    y.backward(cot)
    torch.cuda.synchronize()
    assert (force_default_layout.launches, force_default_layout.backward_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(x.grad[..., :128], force_default_layout_plain(cot))
    assert not x.grad[..., 128:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_cuda_layout_copy_matches_plain(cuda, dtype):
    x = (torch.randn(6, 5, 37, 192, device=cuda) * 50).to(dtype)
    before = force_default_layout.launches
    # vector-load views (the first two, as on the main path) and gather views
    for view in (x[..., :128], x[..., 128:], x.transpose(1, 2), x[:, :, 1:, 3:100], x[0]):
        y = force_default_layout(view)
        assert y.is_contiguous()
        assert torch.equal(y, force_default_layout_plain(view))
    torch.cuda.synchronize()
    assert force_default_layout.launches == before + 5


@pytest.mark.cuda
def test_cuda_wrappers_reject_wrong_dtypes(cuda):
    hh = torch.zeros(N, B, KI, dtype=torch.float16, device=cuda)
    wq, s = quantize_node_weights(torch.from_numpy(_weights()).to(cuda))
    with pytest.raises(TypeError):
        node_apply_q8(hh, wq, s)
    with pytest.raises(TypeError, match="4-byte"):
        force_default_layout(hh)
