"""The port's band kernels on the card (csrc/band_spmm.cu): B7 ``band_spmm``,
B8 ``band_spmm_packed``, B9 ``band_dx`` and ``band_dv`` and the packed
layout's dX and dV, against their plain versions at odd shapes (F = 1, 12,
17, 24, 1536; negative, missing and single offsets; a lone row block; dV
of f32 operands in bf16; faults planted inside dV's f32 kernel), the
autograd terms on the card against the CPU, and one band-form SparseATGCN
training step with its exact launch counts.

Every test is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports no JAX, so it runs on a machine without it:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_band_cuda.py
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
from multistgraph_tpu_torch.ops import band, spmm

BLOCK = 128


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda")


def _planes(cuda, offsets, n_blocks, seed):
    """Random diagonal planes, zero where r + o falls outside the graph (as
    split_band leaves them), on the card."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(len(offsets), n_blocks, BLOCK, BLOCK)).astype(np.float32)
    for i, o in enumerate(offsets):
        for r in range(n_blocks):
            if not 0 <= r + o < n_blocks:
                v[i, r] = 0.0
    return torch.from_numpy(v).to(cuda)


def _close_to_plain(got, want):
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    # the same f32 products, summed in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * max(scale, 1e-30))


OFFSETS = [(-2, -1, 0, 1, 2), (-3, 0, 2), (0,), (1, -1)]


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [1, 12, 17, 24, 128, 1536])
@pytest.mark.parametrize("offsets", OFFSETS, ids=lambda o: "offsets" + "_".join(map(str, o)))
def test_cuda_band_kernels_match_plain(cuda, offsets, feat):
    nb = 6
    v = _planes(cuda, offsets, nb, seed=feat)
    x = torch.randn(nb * BLOCK, feat, device=cuda)
    dy = torch.randn(nb * BLOCK, feat, device=cuda)
    before = {n: getattr(band, n).launches for n in ("band_spmm", "band_dx", "band_dv")}
    _close_to_plain(band.band_spmm(v, offsets, x), band.band_plain(v, offsets, x))
    _close_to_plain(band.band_dx(v, offsets, dy), band.band_dx_plain(v, offsets, dy))
    dv = band.band_dv(dy, x, offsets)
    _close_to_plain(dv, band.band_dv_plain(dy, x, offsets))
    assert {n: getattr(band, n).launches - before[n] for n in before} == dict.fromkeys(before, 1)
    for i, o in enumerate(offsets):  # tiles past the graph's edge are written as zeros
        outside = [r for r in range(nb) if not 0 <= r + o < nb]
        assert not dv[i, outside].any()


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [3, 12, 24, 64, 640])
@pytest.mark.parametrize("radius", [0, 1, 2])
def test_cuda_packed_kernels_match_plain(cuda, radius, feat):
    nb = 5
    offsets = tuple(o for o in range(-radius, radius + 1) if o != 1)  # slot +1 absent
    v_pack = torch.from_numpy(band.pack_band_rows(_planes(cuda, offsets, nb, seed=radius).cpu().numpy(),
                                                  offsets, radius)).to(cuda)
    x = torch.randn(nb * BLOCK, feat, device=cuda)
    dy = torch.randn(nb * BLOCK, feat, device=cuda)
    before = band.band_spmm_packed.launches
    _close_to_plain(band.band_spmm_packed(v_pack, radius, x), band.band_packed_plain(v_pack, radius, x))
    assert band.band_spmm_packed.launches == before + 1
    _close_to_plain(band.band_dx_packed(v_pack, radius, dy), band.band_dx_packed_plain(v_pack, radius, dy))
    _close_to_plain(band.band_dv_packed(dy, x, radius), band.band_dv_packed_plain(dy, x, radius))


@pytest.mark.cuda
def test_cuda_band_one_row_block(cuda):
    v = _planes(cuda, (-1, 0, 1), 1, seed=0)
    x = torch.randn(BLOCK, 7, device=cuda)
    _close_to_plain(band.band_spmm(v, (-1, 0, 1), x), band.band_plain(v, (-1, 0, 1), x))
    _close_to_plain(band.band_dx(v, (-1, 0, 1), x), band.band_dx_plain(v, (-1, 0, 1), x))


def _ratio(got, want, rel=1e-5, bf16_step=False):
    """Largest |got - want| over its bound: rtol rel with atol rel max|want|,
    or one bf16 step (2^-7 |want| + 2^-7 1e-3 max|want|)."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    rel, floor = (2.0 ** -7, 1e-3) if bf16_step else (rel, 1.0)
    diff = (got - want).abs()
    return (diff / (rel * (want.abs() + floor * want.abs().max()))).masked_fill(diff == 0, 0.0).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [3, 24, 128])
@pytest.mark.parametrize("packed", [False, True], ids=["planes", "packed"])
def test_cuda_band_dv_f32_writes_bf16_values(cuda, packed, feat):
    """B9 dV of f32 operands in the values' bf16, planes and packed rows
    (with tiles past the graph's edge): the f32 sums rounded once, so within
    one bf16 step of the plain version."""
    offsets, nb, radius = (-2, -1, 0, 1, 2), 5, 2
    x = torch.randn(nb * BLOCK, feat, device=cuda)
    dy = torch.randn(nb * BLOCK, feat, device=cuda)
    if packed:
        got = band.band_dv_packed(dy, x, radius, torch.bfloat16)
        want = band.band_dv_packed_plain(dy, x, radius, out_dtype=torch.bfloat16)
    else:
        got = band.band_dv(dy, x, offsets, torch.bfloat16)
        want = band.band_dv_plain(dy, x, offsets, out_dtype=torch.bfloat16)
    assert _ratio(got, want, bf16_step=True) <= 1.0
    if not packed:
        assert not got[0, :2].float().any() and not got[4, 3:].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [24, 128])
@pytest.mark.parametrize("packed", [False, True], ids=["planes", "packed"])
def test_cuda_band_dv_planted_faults_fail_the_check(cuda, packed, feat):
    """Each fault planted inside B9 dV's f32 kernel (the k16 slice holding
    the last feature, the middle slot, the graph's last row block) takes it
    past the rtol 1e-5 hold, which it passes without one; the f32 forward
    and dX take no fault and raise."""
    offsets, nb, radius = (-2, -1, 0, 1, 2), 6, 2
    x = torch.randn(nb * BLOCK, feat, device=cuda)
    dy = torch.randn(nb * BLOCK, feat, device=cuda)
    if packed:
        run, want = (lambda: band.band_dv_packed(dy, x, radius)), band.band_dv_packed_plain(dy, x, radius)
    else:
        run, want = (lambda: band.band_dv(dy, x, offsets)), band.band_dv_plain(dy, x, offsets)
    for kind in sorted(band.FAULTS):
        with band.planted_fault(kind):
            bad = run()
        assert _ratio(bad, want) > 1.0, kind
    assert _ratio(run(), want) <= 1.0
    v = _planes(cuda, offsets, nb, seed=1)
    with band.planted_fault("k16"), pytest.raises(RuntimeError, match="CUDA error"):
        band.band_spmm(v, offsets, x)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["planes", "packed"])
def test_cuda_band_gradients_match_the_cpu(cuda, packed):
    offsets, nb = (-2, 0, 1), 4
    v = _planes(cuda, offsets, nb, seed=5).cpu()
    if packed:
        v = torch.from_numpy(band.pack_band_rows(v.numpy(), offsets, 2))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(nb * BLOCK, 24, generator=gen)
    dy = torch.randn(nb * BLOCK, 24, generator=gen)
    out = {}
    for dev in ("cpu", cuda):
        vv = v.to(dev).detach().requires_grad_()
        xx = x.to(dev).detach().requires_grad_()
        y = band.spmm_band_packed(vv, 2, xx) if packed else band.spmm_band(vv, offsets, xx)
        y.backward(dy.to(dev))
        out[str(dev)] = [t.detach().cpu() for t in (y, vv.grad, xx.grad)]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_cuda_band_wrappers_reject_what_the_kernels_do_not_take(cuda):
    v = _planes(cuda, (0, 1), 2, seed=0)
    x = torch.zeros(2 * BLOCK, 8, device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        band.band_spmm(v, (0, 1), x.cpu())
    with pytest.raises(ValueError, match="128x128"):
        band.band_spmm(torch.zeros(1, 4, 64, 64, device=cuda), (0,), torch.zeros(256, 8, device=cuda))
    with pytest.raises(ValueError, match="at most 8 offsets"):
        band.band_spmm(torch.zeros(9, 2, BLOCK, BLOCK, device=cuda), tuple(range(-4, 5)), x)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["planes", "packed"])
def test_cuda_band_training_step_and_forward_launch_the_kernels(tmp_path, packed):
    """One band-form step of the tiny configuration on the card: 2 layers,
    T=4, remat on, the adaptive view over the band's tiles. Per layer: 1
    hoisted and 2 per-step aggregations forward, each one band product and
    one adaptive SpMM, the per-step ones again under remat; then dX of every
    product whose input needs a gradient (not layer 0's hoisted input, nor h
    at t=0): B9 dX for the band, the BSR kernel for the adaptive view, plus
    the SDDMM's forward and its two backward SpMMs and dV (B5) of every
    adaptive SpMM. B9 dV never runs: the band's values are constants. A
    forward without autograd launches 1 + 2T band products per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    args = {"output_dir": str(tmp_path / "out"), "exp_id": "cuda", "num_nodes": 500, "avg_degree": 8,
            "len_time": 48, "input_window": 4, "output_window": 2, "batch_size": 4, "rnn_units": 8,
            "embed_dim_adj": 4, "num_layers": 2, "remat": True, "tensorboard": False, "graph_split": "band",
            "graph_band_packed": packed}
    cfg = load_config("traffic_state_pred", "SparseATGCN", "SYN_LARGE_TINY", other_args=args)
    ds = get_dataset(cfg)
    train, _, _ = ds.get_data()
    feature = ds.get_data_feature()
    model = get_model(cfg, feature)
    executor = get_executor(cfg, model, feature)
    batch = executor.batch(train, train.epoch_permutation()[0])
    t, layers = 4, 2
    counters = (band.band_spmm, band.band_spmm_packed, band.band_dx, band.band_dx_packed, band.band_dv,
                band.band_dv_packed, spmm.bsr_spmm, spmm.sampled_matmul)
    for c in counters:
        c.launches = 0
    if not packed:
        loss = executor.train_step(batch)
        torch.cuda.synchronize()
        assert torch.isfinite(loss)
        forward = layers * (1 + 2 * t) + layers * 2 * t  # and the remat recompute
        dx = layers * (2 * t - 1) + 1  # + layer 1's hoisted input
        assert [c.launches for c in counters] == [forward, 0, dx, 0, 0, 0, forward + dx + 2,
                                                  1 + layers * (1 + 2 * t)]
        for c in counters:
            c.launches = 0
    with torch.no_grad():
        y = model(batch["X"])
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    per = layers * (1 + 2 * t)
    assert [c.launches for c in counters] == [0 if packed else per, per if packed else 0, 0, 0, 0, 0, per, 1]
