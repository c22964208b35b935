"""The bf16 forms of the band kernels and the band-stream probe kernels on the card.

csrc/band_spmm.cu with bfloat16 operands (B7 ``band_spmm``, B8
``band_spmm_packed``, B9 ``band_dx`` and ``band_dv`` and the packed
layout's dX and dV), and csrc/band_probe.cu (``window_dot``, P1 and P3;
``band_slab`` per-row and batched, P2), each against its plain version at
odd shapes; the bf16 autograd terms on the card against the CPU; and one
bf16 band-form SparseATGCN training step with its exact launch counts.

Every test is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports no JAX, so it runs on a machine without it:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_band_bf16_cuda.py
Tolerances, each with its reason:
  * bf16 outputs: within one bf16 step of the plain version, 2^-7 |plain|
    + 2^-7 * 1e-3 max|plain| (both sum the same exact f32 products in
    another order and round once; the two f32 sums can fall on either side
    of a rounding boundary);
  * f32 outputs (window_dot, band_slab, dV in f32): rtol 1e-5 with atol
    1e-5 times max |plain| (the same products, summed in another order).
"""

import numpy as np
import pytest
import torch

from multistgraph_tpu_torch.models.sparse_atgcn import build_sparse_atgcn
from multistgraph_tpu_torch.ops import band, band_probe, bsr, spmm

BLOCK = 128


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda")


def _planes(cuda, offsets, n_blocks, seed, dtype=torch.bfloat16):
    """Random diagonal planes, zero where r + o falls outside the graph."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(len(offsets), n_blocks, BLOCK, BLOCK)).astype(np.float32)
    for i, o in enumerate(offsets):
        for r in range(n_blocks):
            if not 0 <= r + o < n_blocks:
                v[i, r] = 0.0
    return torch.from_numpy(v).to(cuda).to(dtype)


def _randn(cuda, *shape, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=cuda).to(dtype)


def _within_a_bf16_step(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    bound = 2.0 ** -7 * (want.abs() + 1e-3 * want.abs().max())
    assert ((got - want).abs() <= bound).all(), ((got - want).abs() / bound).max().item()


def _close_f32(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * max(want.abs().max().item(), 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [1, 12, 17, 24, 128])
@pytest.mark.parametrize("offsets", [(-2, -1, 0, 1, 2), (-3, 0, 2), (1, -1)],
                         ids=lambda o: "offsets" + "_".join(map(str, o)))
def test_cuda_bf16_band_kernels_match_plain(cuda, offsets, feat):
    nb = 5
    v = _planes(cuda, offsets, nb, seed=feat)
    x = _randn(cuda, nb * BLOCK, feat, seed=1)
    dy = _randn(cuda, nb * BLOCK, feat, seed=2)
    before = {n: getattr(band, n).launches for n in ("band_spmm", "band_dx", "band_dv")}
    _within_a_bf16_step(band.band_spmm(v, offsets, x), band.band_plain(v, offsets, x))
    _within_a_bf16_step(band.band_dx(v, offsets, dy), band.band_dx_plain(v, offsets, dy))
    _within_a_bf16_step(band.band_dv(dy, x, offsets), band.band_dv_plain(dy, x, offsets))
    # dV of bf16 operands into f32 values (the mixed case): f32 sums, unrounded
    _close_f32(band.band_dv(dy, x, offsets, out_dtype=torch.float32),
               band.band_dv_plain(dy, x, offsets, out_dtype=torch.float32))
    assert {n: getattr(band, n).launches - before[n] for n in before} == {"band_spmm": 1, "band_dx": 1,
                                                                          "band_dv": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [3, 64, 768])
@pytest.mark.parametrize("radius", [1, 2])
def test_cuda_bf16_packed_kernels_match_plain(cuda, radius, feat):
    nb = 5
    offsets = tuple(o for o in range(-radius, radius + 1) if o != 1)  # slot +1 absent
    v_pack = band.pack_band_rows(_planes(cuda, offsets, nb, seed=radius), offsets, radius)
    assert v_pack.dtype == torch.bfloat16 and v_pack.is_cuda  # packed on the card, in its dtype
    x = _randn(cuda, nb * BLOCK, feat, seed=3)
    dy = _randn(cuda, nb * BLOCK, feat, seed=4)
    before = band.band_spmm_packed.launches
    _within_a_bf16_step(band.band_spmm_packed(v_pack, radius, x), band.band_packed_plain(v_pack, radius, x))
    assert band.band_spmm_packed.launches == before + 1
    _within_a_bf16_step(band.band_dx_packed(v_pack, radius, dy), band.band_dx_packed_plain(v_pack, radius, dy))
    _within_a_bf16_step(band.band_dv_packed(dy, x, radius), band.band_dv_packed_plain(dy, x, radius))


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["planes", "packed"])
def test_cuda_bf16_band_gradients_match_the_cpu(cuda, packed):
    """bf16 x against f32 values: y and dX in bf16, dV in f32, on the card as
    on the CPU (the same rounding points; f32 sums in other orders)."""
    offsets, nb = (-2, 0, 1), 4
    v = _planes(cuda, offsets, nb, seed=5, dtype=torch.float32).cpu()
    if packed:
        v = band.pack_band_rows(v, offsets, 2)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(nb * BLOCK, 24, generator=gen).bfloat16()
    dy = torch.randn(nb * BLOCK, 24, generator=gen).bfloat16()
    out = {}
    for dev in ("cpu", cuda):
        vv = v.to(dev).detach().requires_grad_()
        xx = x.to(dev).detach().requires_grad_()
        y = band.spmm_band_packed(vv, 2, xx) if packed else band.spmm_band(vv, offsets, xx)
        y.backward(dy.to(dev))
        out[str(dev)] = [t.detach().cpu() for t in (y, vv.grad, xx.grad)]
    got, want = out[str(cuda)], out["cpu"]
    assert [t.dtype for t in got] == [t.dtype for t in want] == [torch.bfloat16, torch.float32, torch.bfloat16]
    for g, w in zip(got, want):
        bound = 2.0 ** -7 * (w.float().abs() + 1e-3 * w.float().abs().max())
        assert ((g.float() - w.float()).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 128, 384, 128, "stack"), (1, 128, 640, 128, "p3"), (3, 100, 50, 70, "odd")],
                         ids=lambda s: s[-1])
def test_cuda_window_dot_matches_plain(cuda, shape):
    c, b, w, f, kind = shape
    v = _randn(cuda, c, b, w, dtype=torch.float32, seed=6)
    rows = c * w if kind == "stack" else 8 * 128
    x = _randn(cuda, rows, f, dtype=torch.float32, seed=7)
    starts = [i * w for i in range(c)] if kind == "stack" else ([128] if kind == "p3" else [0, 17, 500])
    before = band_probe.window_dot.launches
    _close_f32(band_probe.window_dot(v, x, starts), band_probe.window_dot_plain(v, x, starts))
    assert band_probe.window_dot.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [8, 16, 24, 128, 136])
@pytest.mark.parametrize("chunk_rows", [3, 8, 16])
@pytest.mark.parametrize("batched", [False, True], ids=["per_row", "batched"])
def test_cuda_band_slab_matches_plain(cuda, batched, chunk_rows, feat):
    radius, nb = 2, 11  # 11 row blocks: a short last slab at every chunk_rows
    v_pack = _randn(cuda, nb, BLOCK, (2 * radius + 1) * BLOCK, seed=8)
    xp = _randn(cuda, nb + 2 * radius, BLOCK, feat, seed=9)
    counts = (band_probe.band_slab.launches, band_probe.band_slab.batched_launches)
    _close_f32(band_probe.band_slab(v_pack, xp, radius, chunk_rows=chunk_rows, batched=batched),
               band_probe.band_slab_plain(v_pack, xp, radius))
    assert (band_probe.band_slab.launches - counts[0], band_probe.band_slab.batched_launches - counts[1]) == (
        (0, 1) if batched else (1, 0))


@pytest.mark.cuda
def test_cuda_probe_wrappers_reject_what_the_kernels_do_not_take(cuda):
    v_pack = _randn(cuda, 2, BLOCK, 3 * BLOCK)
    with pytest.raises(ValueError, match="multiple of 8"):
        band_probe.band_slab(v_pack, _randn(cuda, 4, BLOCK, 12), 1)
    with pytest.raises(TypeError, match="bfloat16"):
        band_probe.band_slab(v_pack.float(), _randn(cuda, 4, BLOCK, 16).float(), 1)
    with pytest.raises(ValueError, match="leaves x"):
        band_probe.window_dot(_randn(cuda, 1, 4, 8, dtype=torch.float32), _randn(cuda, 10, 3, dtype=torch.float32),
                              [3])


@pytest.mark.cuda
def test_cuda_bf16_band_training_step_launches_the_kernels(cuda):
    """One bf16 step of a tiny band SparseATGCN without the adaptive view:
    per layer 1 hoisted and 2T per-step band products forward and 2T again
    under remat, and B9 dX of every product whose input needs a gradient;
    no BSR kernel. Loss finite, gradients f32, predictions f32."""
    graph = bsr.random_spatial_graph(700, 8, seed=3, split="band")[0]
    cfg = {"output_window": 2, "output_dim": 1, "rnn_units": 8, "num_layers": 2, "embed_dim_adj": 4,
           "adpadj": "none", "remat": True, "compute_dtype": "bfloat16"}
    model = build_sparse_atgcn(graph, cfg, device=cuda)
    assert model.support0_band_values.dtype == torch.bfloat16
    t, layers = 4, 2
    x = _randn(cuda, 2, t, model.num_nodes, 1, dtype=torch.float32, seed=10)
    counters = (band.band_spmm, band.band_dx, band.band_dv, spmm.bsr_spmm, spmm.sampled_matmul)
    for fn in counters:
        fn.launches = 0
    out = model(x, train=True)
    loss = out.abs().mean()
    loss.backward()
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all() for p in model.parameters())
    assert [fn.launches for fn in counters] == [layers * (1 + 2 * t) + layers * 2 * t, layers * (2 * t - 1) + 1,
                                                0, 0, 0]
