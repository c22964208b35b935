"""Kernels B2 (int8 node apply) and B3 (layout copy) of the port.

On the CPU the wrappers take their plain versions, which are held against
the JAX package (the Pallas kernel in interpret mode). The tests marked
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
