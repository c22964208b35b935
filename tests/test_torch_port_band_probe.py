"""The band-stream probes and the large-graph bench of the port against the
JAX package, on the CPU.

  * P1 and P3: ``window_dot``'s plain version on the JAX tool's seeded
    inputs (tools/probe_band_stream.py, numpy seeds 0 and 1) against the
    tool's own einsum references, and the JAX tool's two Pallas probes in
    interpret mode;
  * P2: ``band_slab``'s plain version against JAX's slab kernel
    (ops/band.py:band_fwd_slab_pallas, interpret mode, chunk_rows 3, both
    dot modes) on 5 row blocks in bf16;
  * the port's probe tool (``--small``) and bench_large_graph on the CPU at
    4,096 nodes, band form, bf16: one training step and one packed serving
    call.
Tolerances: P1/P3 rtol 1e-5 with atol 1e-5 times max |JAX| (f32 products
summed in another order); P2 the same (bf16 products exact in f32 on both
sides, f32 sums). The CUDA kernels run only on the card:
tests/test_torch_port_band_bf16_cuda.py holds them against these plain
versions.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multistgraph_tpu.ops.band import band_fwd_slab_pallas
from multistgraph_tpu_torch.ops import band_probe
from multistgraph_tpu_torch.tools import bench_large_graph, probe_band_stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other CPU tests use beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX package's tools/probe_band_stream.py (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location("jax_probe_band_stream",
                                                  os.path.join(ROOT, "tools", "probe_band_stream.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_p1_window_dot_matches_the_jax_tools_batched_dot(jax_tool):
    assert jax_tool.probe_batched_dot(True)  # the TPU kernel, interpreted
    c, w, f = 4, 3 * 128, 128
    rng = np.random.default_rng(0)  # the JAX tool's inputs
    v = rng.normal(size=(c, 128, w)).astype(np.float32)
    x = rng.normal(size=(c, w, f)).astype(np.float32)
    want = jnp.einsum("cbw,cwf->cbf", jnp.asarray(v), jnp.asarray(x))
    got = band_probe.window_dot(torch.from_numpy(v), torch.from_numpy(x).reshape(c * w, f),
                                [i * w for i in range(c)])
    _close(got, want)


def test_p3_window_dot_matches_the_jax_tools_slice_reshape(jax_tool):
    assert jax_tool.probe_slice_reshape(True)
    w, f = 5 * 128, 128
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(8, 128, f)).astype(np.float32)
    v = rng.normal(size=(128, w)).astype(np.float32)
    want = jnp.asarray(v) @ jnp.asarray(xs)[1:6].reshape(w, f)
    got = band_probe.window_dot(torch.from_numpy(v)[None], torch.from_numpy(xs).reshape(8 * 128, f), [128])
    _close(got[0], want)


@pytest.mark.parametrize("batched", [False, True], ids=["per_row", "batched"])
def test_p2_band_slab_matches_the_jax_slab_kernel(batched):
    radius, nb, f = 2, 5, 16
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.normal(size=(nb, 128, (2 * radius + 1) * 128)).astype(np.float32)).bfloat16()
    xp = torch.from_numpy(rng.normal(size=(nb + 2 * radius, 128, f)).astype(np.float32)).bfloat16()
    want = band_fwd_slab_pallas(jnp.asarray(v.float().numpy()).astype(jnp.bfloat16),
                                jnp.asarray(xp.float().numpy()).astype(jnp.bfloat16), radius, chunk_rows=3,
                                batched=batched, interpret=True)
    got = band_probe.band_slab(v, xp, radius, chunk_rows=3, batched=batched)
    assert got.dtype == torch.float32 and got.shape == (nb, 128, f)
    _close(got, want)


def test_probe_wrappers_reject_what_they_do_not_take():
    v = torch.zeros(2, 128, 384, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        band_probe.band_slab(v.float(), torch.zeros(4, 128, 8), 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        band_probe.band_slab(v, torch.zeros(3, 128, 8, dtype=torch.bfloat16), 1)
    with pytest.raises(ValueError, match="leaves x"):
        band_probe.window_dot(torch.zeros(1, 4, 8), torch.zeros(10, 3), [3])
    with pytest.raises(ValueError, match="C starts"):
        band_probe.window_dot(torch.zeros(2, 4, 8), torch.zeros(10, 3), [0])


def test_probe_tool_small_runs_every_probe_on_the_cpu(capsys):
    record = probe_band_stream.main(["--small"])
    assert record["ok"] and record["device"] == "cpu"
    assert record["P2"]["shape"]["row_blocks"] == probe_band_stream.SMALL_ROW_BLOCKS
    assert all(record[p]["ms"] is None for p in ("P1", "P3"))  # no time from a CPU run
    out = capsys.readouterr()
    assert "[P1 batched-dot] OK" in out.err and "[P2 batched dot] OK" in out.err
    assert json.loads(out.out.strip().splitlines()[-1])["probe_band_stream"]["ok"]


@pytest.mark.parametrize("serve", [False, True], ids=["train", "serve_packed"])
def test_bench_large_graph_runs_the_bf16_band_on_the_cpu(capsys, serve):
    argv = ["4096", "16", "3", "1", "band", "--dtype", "bf16", "--adpadj", "none", "--hidden", "8",
            "--iters", "1", "--device", "cpu"] + (["--serve", "--band-packed"] if serve else [])
    record = bench_large_graph.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(json.dumps(record))
    extras = record["extras"]
    assert (extras["num_nodes"], extras["split"], extras["dtype"], extras["device"]) == (4096, "band", "bf16", "cpu")
    assert record["value"] > 0 and "peak_memory_gb" not in extras  # no device metric from a CPU run
    if serve:
        assert record["metric"] == "sparse_serve_latency_4k_band_packed" and record["unit"] == "ms"
    else:
        assert record["metric"] == "sparse_train_edges_per_second_4k_band"
        assert len(extras["losses"]) == bench_large_graph.WARMUP + 1 and np.isfinite(extras["losses"]).all()


@pytest.mark.parametrize("flag,item", [(["--family", "planted"], "A.6.2"), (["--boundary-stats"], "A.7")])
def test_bench_large_graph_unported_options_raise(flag, item):
    with pytest.raises(NotImplementedError, match="ROADMAP.md " + item):
        bench_large_graph.main(["512", "8", "2", "1", "band", "--device", "cpu"] + flag)


def test_band_slab_planted_faults_are_scoped_and_leave_the_cpu_path_alone():
    gen = torch.Generator().manual_seed(4)
    v_pack = torch.randn(3, 128, 3 * 128, generator=gen).bfloat16()
    xp = torch.randn(5, 128, 8, generator=gen).bfloat16()
    want = band_probe.band_slab(v_pack, xp, 1)
    with pytest.raises(KeyError):
        with band_probe.planted_fault("no such fault"):
            pass
    for kind in sorted(band_probe.FAULTS):
        with band_probe.planted_fault(kind):
            assert band_probe._planted == band_probe.FAULTS[kind]
            assert torch.equal(band_probe.band_slab(v_pack, xp, 1, batched=True), want)
        assert band_probe._planted == 0


def test_window_dot_planted_faults_are_scoped_and_leave_the_cpu_path_alone():
    gen = torch.Generator().manual_seed(5)
    v = torch.randn(3, 10, 20, generator=gen)
    x = torch.randn(60, 7, generator=gen)
    starts = [0, 13, 40]
    want = band_probe.window_dot(v, x, starts)
    assert set(band_probe.WINDOW_FAULTS).isdisjoint(band_probe.FAULTS)
    for kind in sorted(band_probe.WINDOW_FAULTS):
        with band_probe.planted_fault(kind):
            assert band_probe._window_planted == band_probe.WINDOW_FAULTS[kind] and band_probe._planted == 0
            assert torch.equal(band_probe.window_dot(v, x, starts), want)
        assert band_probe._window_planted == 0
