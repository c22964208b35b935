"""The bf16 forms of the BSR kernels on the card: B4/B6 (``bsr_spmm``,
csrc/bsr_spmm.cu) and B5 (``sampled_matmul``, csrc/sampled_matmul.cu) on
the tensor cores, each against its plain version at odd shapes (one tile,
empty row blocks, no tile at all, a rectangular A; F = 1 to 1536 on both
load paths, x by TMA where F % 8 == 0, else by element loads; d = 1 to
1536), the faults planted in them, the bf16 autograd terms on the card
against the CPU, and one bf16 SparseATGCN training step on the BSR, hub and
tail forms with its exact launch counts.

Every test is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports no JAX, so it runs on a machine without it:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_sparse_bf16_cuda.py
Tolerances, each with its reason:
  * bsr_spmm's f32 sums: rtol 1e-5 with atol 1e-5 times max |plain| (the
    kernel and the plain version sum the same exact products of bf16
    values in f32, in another order);
  * bf16 outputs (sampled_matmul's tiles, the bf16 gradients): within one
    bf16 step of the plain version, 2^-7 |plain| + 2^-7 * 1e-3 max|plain|
    (the same f32 sums in another order, rounded once: they can fall on
    either side of a rounding boundary).
"""

import numpy as np
import pytest
import torch

from multistgraph_tpu_torch.models.sparse_atgcn import build_sparse_atgcn
from multistgraph_tpu_torch.ops import bsr, spmm

BLOCK = 128


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda")


def _card_graph(cuda, n_blocks, nnz, seed, empty_rows=(), out_blocks=None):
    """A random pattern of `nnz` tiles of an (out_blocks x n_blocks)-block
    A (row-major, rows in `empty_rows` left out), bf16 values, on the card."""
    out_blocks = n_blocks if out_blocks is None else out_blocks
    rng = np.random.default_rng(seed)
    rows = [r for r in range(out_blocks) if r not in empty_rows]
    keys = np.sort(rng.choice(len(rows) * n_blocks, size=nnz, replace=False))
    row = np.asarray(rows, np.int64)[keys // n_blocks].astype(np.int32)
    col = (keys % n_blocks).astype(np.int32)
    values = torch.from_numpy(rng.normal(size=(nnz, BLOCK, BLOCK)).astype(np.float32)).to(cuda).bfloat16()
    row_t = torch.from_numpy(row).to(cuda)
    return values, row_t, spmm.row_ptr_of(row_t, out_blocks), torch.from_numpy(col).to(cuda)


def _randn(cuda, *shape, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=cuda).bfloat16()


def _f32_ratio(got, want):
    """Largest |got - want| over rtol 1e-5 |want| + 1e-5 max|want|."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    bound = 1e-5 * (want.abs() + want.abs().max())
    return ((got - want).abs() / bound).max().item()


def _bf16_step_ratio(got, want):
    """Largest |got - want| over one bf16 step of want."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    bound = 2.0 ** -7 * (want.abs() + 1e-3 * want.abs().max())
    return ((got - want).abs() / bound).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [1, 12, 16, 17, 24, 64, 128, 200, 768, 1536])
def test_cuda_bf16_bsr_spmm_matches_plain(cuda, feat):
    values, row, ptr, col = _card_graph(cuda, 6, 14, seed=feat, empty_rows=(2, 5))
    x = _randn(cuda, 6 * BLOCK, feat, seed=feat)
    before = (spmm.bsr_spmm.launches, spmm.bsr_spmm.bf16_launches)
    got = spmm.bsr_spmm(values, row, ptr, col, x, 6)
    assert (spmm.bsr_spmm.launches, spmm.bsr_spmm.bf16_launches) == (before[0], before[1] + 1)
    want = spmm.spmm_plain(values, row, col, x, out_blocks=6)
    assert _f32_ratio(got, want) <= 1.0
    assert not got[2 * BLOCK:3 * BLOCK].any() and not got[5 * BLOCK:].any()   # the empty row blocks


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [12, 24, 128])
def test_cuda_bf16_bsr_spmm_one_tile_no_tile_and_rectangular(cuda, feat):
    values, row, ptr, col = _card_graph(cuda, 1, 1, seed=1)
    x = _randn(cuda, BLOCK, feat, seed=2)
    assert _f32_ratio(spmm.bsr_spmm(values, row, ptr, col, x, 1), spmm.spmm_plain(values, row, col, x)) <= 1.0
    # no tile at all: zeros
    empty = values[:0].contiguous()
    none = spmm.bsr_spmm(empty, row[:0].contiguous(), torch.zeros(4, dtype=torch.int32, device=cuda),
                         col[:0].contiguous(), _randn(cuda, 2 * BLOCK, feat), 3)
    torch.cuda.synchronize()
    assert none.shape == (3 * BLOCK, feat) and none.dtype == torch.float32 and not none.any()
    # A with 5 row blocks over an x of 3 (and 2 over 7), as the transposed
    # product of a rectangular A
    for out_blocks, in_blocks in ((5, 3), (2, 7)):
        values, row, ptr, col = _card_graph(cuda, in_blocks, 6, seed=out_blocks, out_blocks=out_blocks)
        x = _randn(cuda, in_blocks * BLOCK, feat, seed=3)
        got = spmm.bsr_spmm(values, row, ptr, col, x, out_blocks)
        assert _f32_ratio(got, spmm.spmm_plain(values, row, col, x, out_blocks=out_blocks)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 12, 16, 24, 64, 100, 128, 1536])
def test_cuda_bf16_sampled_matmul_matches_plain(cuda, d):
    _, row, _, col = _card_graph(cuda, 5, 9, seed=d)
    a, bt = _randn(cuda, 5 * BLOCK, d, seed=1), _randn(cuda, 5 * BLOCK, d, seed=2)
    before = (spmm.sampled_matmul.launches, spmm.sampled_matmul.bf16_launches)
    got = spmm.sampled_matmul(a, bt, row, col)
    assert (spmm.sampled_matmul.launches, spmm.sampled_matmul.bf16_launches) == (before[0], before[1] + 1)
    assert got.dtype == torch.bfloat16
    assert _bf16_step_ratio(got, spmm.sampled_matmul_plain(a, bt, row, col)) <= 1.0


@pytest.mark.cuda
def test_cuda_bf16_sampled_matmul_rectangular_operands(cuda):
    """a and bt of different row counts (row_of indexes a's blocks, col_of bt's)."""
    row = torch.tensor([0, 0, 2], dtype=torch.int32, device=cuda)
    col = torch.tensor([1, 5, 0], dtype=torch.int32, device=cuda)
    a, bt = _randn(cuda, 3 * BLOCK, 24, seed=4), _randn(cuda, 6 * BLOCK, 24, seed=5)
    assert _bf16_step_ratio(spmm.sampled_matmul(a, bt, row, col), spmm.sampled_matmul_plain(a, bt, row, col)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(spmm.FAULTS))
def test_cuda_bf16_planted_faults_fail_the_check(cuda, fault):
    """Each fault planted in the bf16 kernels takes them past their check, on
    both load paths; without it they pass."""
    values, row, ptr, col = _card_graph(cuda, 4, 9, seed=7)
    for feat in (12, 128):
        x = _randn(cuda, 4 * BLOCK, feat, seed=feat)
        want = spmm.spmm_plain(values, row, col, x)
        assert _f32_ratio(spmm.bsr_spmm(values, row, ptr, col, x, 4), want) <= 1.0
        with spmm.planted_fault(fault):
            assert _f32_ratio(spmm.bsr_spmm(values, row, ptr, col, x, 4), want) > 1.0
    for d in (12, 16, 24):
        a, bt = _randn(cuda, 4 * BLOCK, d, seed=d), _randn(cuda, 4 * BLOCK, d, seed=d + 1)
        want = spmm.sampled_matmul_plain(a, bt, row, col)
        assert _bf16_step_ratio(spmm.sampled_matmul(a, bt, row, col), want) <= 1.0
        with spmm.planted_fault(fault):
            assert _bf16_step_ratio(spmm.sampled_matmul(a, bt, row, col), want) > 1.0


@pytest.mark.cuda
def test_cuda_bf16_kernels_raise_on_a_misaligned_operand(cuda):
    """A TMA view of an operand that is not 16-byte aligned cannot be
    encoded: the launch returns the error and the wrapper raises. At a width
    the element loads take (x of F = 12) the same operand runs."""
    values, row, ptr, col = _card_graph(cuda, 2, 3, seed=8)

    def misaligned(rows, feat):
        return _randn(cuda, rows * feat + 1, seed=9)[1:].reshape(rows, feat)

    with pytest.raises(RuntimeError, match="launch failed"):
        spmm.bsr_spmm(values, row, ptr, col, misaligned(2 * BLOCK, 64), 2)
    with pytest.raises(RuntimeError, match="launch failed"):
        spmm.bsr_spmm(_misaligned_tiles(values), row, ptr, col, _randn(cuda, 2 * BLOCK, 64), 2)
    with pytest.raises(RuntimeError, match="launch failed"):
        spmm.sampled_matmul(misaligned(2 * BLOCK, 16), _randn(cuda, 2 * BLOCK, 16), row, col)
    x12 = misaligned(2 * BLOCK, 12)
    assert _f32_ratio(spmm.bsr_spmm(values, row, ptr, col, x12, 2), spmm.spmm_plain(values, row, col, x12)) <= 1.0
    a12 = misaligned(2 * BLOCK, 12)
    got = spmm.sampled_matmul(a12, a12.clone(), row, col)
    assert _bf16_step_ratio(got, spmm.sampled_matmul_plain(a12, a12.clone(), row, col)) <= 1.0


def _misaligned_tiles(values):
    """The same tiles in storage that starts 2 bytes past a 16-byte boundary."""
    flat = torch.empty(values.numel() + 1, dtype=values.dtype, device=values.device)
    out = flat[1:].view(values.shape)
    out.copy_(values)
    return out


@pytest.mark.cuda
def test_cuda_bf16_autograd_terms_match_the_cpu(cuda):
    """spmm (with and without a precomputed transpose) and sddmm_relu in
    bf16: y in f32, dV, dX, the scores and dE1/dE2 in bf16, on the card as
    on the CPU (the same rounding points; f32 sums in other orders)."""
    values, row, _, col = _card_graph(cuda, 4, 7, seed=3)
    values, row, col = values.cpu(), row.cpu(), col.cpu()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4 * BLOCK, 24, generator=gen).bfloat16()
    dy = torch.randn(4 * BLOCK, 24, generator=gen)
    e1 = (torch.randn(4 * BLOCK, 16, generator=gen) * 0.3).bfloat16()
    e2 = (torch.randn(16, 4 * BLOCK, generator=gen) * 0.3).bfloat16()
    ds = torch.randn(7, BLOCK, BLOCK, generator=gen).bfloat16()
    out = {}
    for dev in ("cpu", cuda):
        terms = []
        for pre in (False, True):
            v = values.to(dev).detach().requires_grad_()
            xx = x.to(dev).detach().requires_grad_()
            r, c = row.to(dev), col.to(dev)
            if pre:
                y = spmm.spmm_pret(v, spmm.bsr_transpose_plan(v.detach(), r, c, 4), r, c, xx)
            else:
                y = spmm.spmm(v, r, c, xx)
            y.backward(dy.to(dev))
            terms += [y, v.grad, xx.grad]
        a, b = e1.to(dev).detach().requires_grad_(), e2.to(dev).detach().requires_grad_()
        s = spmm.sddmm_relu(a, b, row.to(dev), col.to(dev))
        s.backward(ds.to(dev))
        out[str(dev)] = [t.detach().cpu() for t in terms + [s, a.grad, b.grad]]
    got, want = out[str(cuda)], out["cpu"]
    assert [t.dtype for t in want] == [torch.float32, torch.bfloat16, torch.bfloat16] * 2 + [torch.bfloat16] * 3
    for g, w in zip(got, want):
        if w.dtype == torch.float32:
            assert _f32_ratio(g.to(cuda), w.to(cuda)) <= 1.0
        else:
            assert _bf16_step_ratio(g, w) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, "hub", "tail"], ids=["bsr", "hub", "tail"])
def test_cuda_bf16_training_step_launches_the_kernels(cuda, split):
    """One bf16 step of a tiny SparseATGCN with the adaptive view and remat:
    per layer 1 hoisted and 2T per-step aggregations forward (2 SpMMs each:
    the static support and the adaptive view) and 2T again under remat, dX
    of every SpMM whose input needs a gradient (not layer 0's hoisted input,
    nor h at t=0), dV (B5) of every adaptive SpMM, the SDDMM's forward and
    its two backward SpMMs; all on the bf16 kernels, none on the f32 ones.
    Loss finite, gradients f32, predictions f32."""
    graph = bsr.random_spatial_graph(700, 8, seed=3, split=split)[0]
    cfg = {"output_window": 2, "output_dim": 1, "rnn_units": 8, "num_layers": 2, "embed_dim_adj": 4,
           "adpadj": "unidirection", "remat": True, "compute_dtype": "bfloat16"}
    model = build_sparse_atgcn(graph, cfg, device=cuda)
    assert model.support0_values.dtype == torch.bfloat16
    t, layers = 4, 2
    x = torch.randn(2, t, model.num_nodes, 1, generator=torch.Generator(device=cuda).manual_seed(10), device=cuda)
    spmm.bsr_spmm.launches = spmm.bsr_spmm.bf16_launches = 0
    spmm.sampled_matmul.launches = spmm.sampled_matmul.bf16_launches = 0
    out = model(x, train=True)
    loss = out.abs().mean()
    loss.backward()
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all() for p in model.parameters())
    forward = layers * 2 * (1 + 2 * t)
    recompute = layers * 2 * 2 * t
    dx = layers * 2 * (2 * t - 1) + 2  # + layer 1's hoisted input
    assert (spmm.bsr_spmm.launches, spmm.sampled_matmul.launches) == (0, 0)
    assert spmm.bsr_spmm.bf16_launches == forward + recompute + dx + 2
    assert spmm.sampled_matmul.bf16_launches == 1 + layers * (1 + 2 * t)


@pytest.mark.cuda
def test_cuda_wrappers_take_bf16_and_reject_other_dtypes(cuda):
    """bf16 operands of one dtype are taken (f32 sums from bsr_spmm, bf16
    tiles from sampled_matmul); float64 and mixed dtypes (bf16 against f32
    or f16) raise. f16 operands have kernels of their own
    (tests/test_torch_port_f16_cuda.py)."""
    values, row, ptr, col = _card_graph(cuda, 2, 2, seed=0)
    x = _randn(cuda, 2 * BLOCK, 8)
    assert spmm.bsr_spmm(values, row, ptr, col, x, 2).dtype == torch.float32
    assert spmm.sampled_matmul(x, x, row, col).dtype == torch.bfloat16
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        spmm.bsr_spmm(values.double(), row, ptr, col, x.double(), 2)
    with pytest.raises(TypeError, match="of one dtype"):
        spmm.bsr_spmm(values, row, ptr, col, x.float(), 2)
    with pytest.raises(TypeError, match="of one dtype"):
        spmm.bsr_spmm(values, row, ptr, col, x.half(), 2)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        spmm.sampled_matmul(x.double(), x.double(), row, col)
