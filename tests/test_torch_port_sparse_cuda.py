"""The port's sparse kernels on the card: B4/B6 (``bsr_spmm``,
csrc/bsr_spmm.cu) and B5 (``sampled_matmul``, csrc/sampled_matmul.cu)
against their plain versions at odd shapes (F = 1, 17, 1536; empty row
blocks; one tile; a rectangular A), the autograd terms on the card against
the CPU, and one SparseATGCN training step with its exact launch counts.

Every test is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports no JAX, so it runs on a machine without it:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_sparse_cuda.py
Tolerance of kernel against plain version: rtol 1e-5 with atol 1e-5 times
max |plain| (the same f32 products, summed in another order).
"""

import numpy as np
import pytest
import torch

from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.executor import get_executor
from multistgraph_tpu_torch.models import get_model
from multistgraph_tpu_torch.ops import spmm

BLOCK = 128


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda")


def _card_graph(cuda, n_blocks, nnz, seed, empty_rows=()):
    """A random pattern of `nnz` tiles (row-major, rows in `empty_rows` left
    out) with random values, on the card."""
    rng = np.random.default_rng(seed)
    rows = [r for r in range(n_blocks) if r not in empty_rows]
    keys = rng.choice(len(rows) * n_blocks, size=nnz, replace=False)
    keys.sort()
    row = np.asarray(rows)[keys // n_blocks].astype(np.int32)
    col = (keys % n_blocks).astype(np.int32)
    values = rng.normal(size=(nnz, BLOCK, BLOCK)).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    row_t = to(row)
    return to(values), row_t, spmm.row_ptr_of(row_t, n_blocks), to(col)


def _close_to_plain(got, want):
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    # the same f32 products, summed in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * max(scale, 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [1, 17, 24, 64, 128, 1536])
def test_cuda_bsr_spmm_matches_plain(cuda, feat):
    values, row, ptr, col = _card_graph(cuda, 6, 14, seed=feat, empty_rows=(2, 5))
    x = torch.randn(6 * BLOCK, feat, device=cuda)
    before = spmm.bsr_spmm.launches
    got = spmm.bsr_spmm(values, row, ptr, col, x, 6)
    assert spmm.bsr_spmm.launches == before + 1
    _close_to_plain(got, spmm.spmm_plain(values, row, col, x, out_blocks=6))
    assert not got[2 * BLOCK: 3 * BLOCK].any() and not got[5 * BLOCK:].any()


@pytest.mark.cuda
def test_cuda_bsr_spmm_one_tile_and_rectangular(cuda):
    values, row, ptr, col = _card_graph(cuda, 1, 1, seed=0)
    x = torch.randn(BLOCK, 17, device=cuda)
    _close_to_plain(spmm.bsr_spmm(values, row, ptr, col, x, 1), spmm.spmm_plain(values, row, col, x, out_blocks=1))
    # 3 output row blocks read from a 2-block x
    values, row, ptr, col = _card_graph(cuda, 2, 3, seed=1)
    ptr3 = spmm.row_ptr_of(row, 3)
    x = torch.randn(2 * BLOCK, 40, device=cuda)
    _close_to_plain(spmm.bsr_spmm(values, row, ptr3, col, x, 3), spmm.spmm_plain(values, row, col, x, out_blocks=3))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 16, 17, 128, 1536])
def test_cuda_sampled_matmul_matches_plain(cuda, d):
    values, row, _, col = _card_graph(cuda, 5, 9, seed=d, empty_rows=(1,))
    a = torch.randn(5 * BLOCK, d, device=cuda)
    bt = torch.randn(5 * BLOCK, d, device=cuda)
    before = spmm.sampled_matmul.launches
    got = spmm.sampled_matmul(a, bt, row, col)
    assert spmm.sampled_matmul.launches == before + 1
    _close_to_plain(got, spmm.sampled_matmul_plain(a, bt, row, col))
    _, row1, _, col1 = _card_graph(cuda, 1, 1, seed=0)
    _close_to_plain(spmm.sampled_matmul(a, bt, row1, col1), spmm.sampled_matmul_plain(a, bt, row1, col1))


@pytest.mark.cuda
def test_cuda_gradients_match_plain(cuda):
    """spmm and sddmm_relu gradients on the card against the same functions
    on the CPU (the plain versions)."""
    values, row, ptr, col = _card_graph(cuda, 4, 7, seed=3, empty_rows=(0,))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4 * BLOCK, 24, generator=gen)
    dy = torch.randn(4 * BLOCK, 24, generator=gen)
    e1 = torch.randn(4 * BLOCK, 16, generator=gen) * 0.3
    e2 = torch.randn(16, 4 * BLOCK, generator=gen) * 0.3
    ds = torch.randn(7, BLOCK, BLOCK, generator=gen)
    out = {}
    for dev in ("cpu", cuda):
        v = values.to(dev).detach().requires_grad_()
        xx = x.to(dev).detach().requires_grad_()
        r, c = row.to(dev), col.to(dev)
        spmm.spmm(v, r, c, xx).backward(dy.to(dev))
        a, b = e1.to(dev).detach().requires_grad_(), e2.to(dev).detach().requires_grad_()
        s = spmm.sddmm_relu(a, b, r, c)
        s.backward(ds.to(dev))
        out[str(dev)] = [t.detach().cpu() for t in (v.grad, xx.grad, s, a.grad, b.grad)]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    values, row, ptr, col = _card_graph(cuda, 2, 2, seed=0)
    x = torch.zeros(2 * BLOCK, 8, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        spmm.bsr_spmm(values.half(), row, ptr, col, x, 2)
    with pytest.raises(ValueError, match="different devices"):
        spmm.bsr_spmm(values, row, ptr, col, x.cpu(), 2)
    with pytest.raises(ValueError, match="128x128"):
        small = torch.zeros(2, 64, 64, device=cuda)
        spmm.bsr_spmm(small, row, ptr, col, torch.zeros(128, 8, device=cuda), 2)


@pytest.mark.cuda
def test_cuda_training_step_launches_the_kernels(tmp_path):
    """One step of the tiny configuration on the card: 2 layers, T=4, remat
    on, the adaptive view. Per layer: 1 hoisted and 2 per-step aggregations
    forward (2 SpMM each: static and adaptive), the per-step ones again
    under remat, then dX of every SpMM whose input needs a gradient (not
    layer 0's hoisted input, nor h at t=0 for the h aggregation) and dV
    (B5) of every adaptive SpMM; plus the SDDMM forward and its two
    backward SpMMs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    args = {"output_dir": str(tmp_path / "out"), "exp_id": "cuda", "num_nodes": 200, "avg_degree": 8,
            "len_time": 48, "input_window": 4, "output_window": 2, "batch_size": 4, "rnn_units": 8,
            "embed_dim_adj": 4, "num_layers": 2, "remat": True, "tensorboard": False}
    cfg = load_config("traffic_state_pred", "SparseATGCN", "SYN_LARGE_TINY", other_args=args)
    ds = get_dataset(cfg)
    train, _, _ = ds.get_data()
    feature = ds.get_data_feature()
    executor = get_executor(cfg, get_model(cfg, feature), feature)
    batch = executor.batch(train, train.epoch_permutation()[0])
    spmm.bsr_spmm.launches = spmm.sampled_matmul.launches = 0
    loss = executor.train_step(batch)
    torch.cuda.synchronize()
    t, layers = 4, 2
    forward = layers * 2 * (1 + 2 * t)
    recompute = layers * 2 * 2 * t
    dx = layers * 2 * (2 * t - 1) + 2  # + layer 1's hoisted input
    assert spmm.bsr_spmm.launches == forward + recompute + dx + 2
    assert spmm.sampled_matmul.launches == 1 + layers * (1 + 2 * t)
    assert torch.isfinite(loss)
