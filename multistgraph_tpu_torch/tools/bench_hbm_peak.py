"""The card's streaming and matmul ceilings, measured by the slope method.

Counterpart of tools/bench_hbm_peak.py. Every measurement runs the same
loop at several trip counts and takes the least-squares slope of wall time
against trips (``tools.timing.slope_time``), so launch and synchronisation
costs cancel. Each iteration depends on the one before through a scalar
carry (a slice start, an operand poke or the chained output), as on the
TPU, although PyTorch hoists nothing out of an eager loop.

  read       x[i%2 : rows-2+i%2].sum() over a 256 MB array (f32, bf16)
  copy       the same slice plus the carry, written out (read + write)
  matmul stream  an (8, M) @ (M, 512) product: the (M, 512) operand streams
                 from device memory, FLOPs negligible
  kernel read    the stream-read kernel's column-sum mode (B10,
                 ``ops.stream_read.column_sum_read``, csrc/stream_read.cu)
                 over 256 MB of bf16 at the TPU bench's three block shapes
                 (512x512, 2048x512, 2048x1024), which set the grid count
                 in its output; the kernel tiles the rows its own way
  matmul peak    chained tanh(h @ w) at n = 4096, bf16 and f32 (TF32 off)

Arrays of 256 MB are five times the 50 MB L2, so every read comes from
device memory. Run from the repository root on the card:
    python -m multistgraph_tpu_torch.tools.bench_hbm_peak
It prints GB/s and TFLOP/s with the card's name and power limit and one
JSON line; it raises without a CUDA device.
"""

import json
import time

import torch

from multistgraph_tpu_torch.ops.stream_read import checksum_value, column_sum_read, column_sum_read_plain
from multistgraph_tpu_torch.tools import timing
from multistgraph_tpu_torch.utils.device import resolve_device

MB = 1024 * 1024
KERNEL_BLOCKS = ((512, 512), (2048, 512), (2048, 1024))   # tools/bench_hbm_peak.py:230-232


def _slope(label, make_fn, num_bytes=None, flops=None):
    per_iter, totals = timing.slope_time(make_fn)
    rate = (num_bytes / per_iter / 1e9) if num_bytes else (flops / per_iter / 1e12)
    print("  {:44s} {:8.1f} {} ({:.4f} ms/iter; totals {} ms)".format(
        label, rate, "GB/s" if num_bytes else "TFLOP/s", per_iter * 1e3,
        "/".join("{:.1f}".format(t * 1e3) for t in totals)), flush=True)
    return rate


def _randn(shape, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def read_bw(dtype, total_mb):
    """Pure read: a fused slice-and-sum whose start alternates 0/1 rows."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows = total_mb * MB // (itemsize * 512)
    x = _randn((rows, 512), dtype)

    def make(k):
        def run():
            c = torch.zeros((), device="cuda")
            for i in range(k):
                c = c + x[i % 2: rows - 2 + i % 2].sum(dtype=torch.float32) * 1e-12
            return c
        return run

    return _slope("read  {} {}MB".format(str(dtype).split(".")[-1], total_mb), make,
                  num_bytes=(rows - 2) * 512 * itemsize)


def copy_bw(dtype, total_mb):
    """Read + write: the shifted slice plus the carry, materialized."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows = total_mb * MB // (itemsize * 512)
    x = _randn((rows, 512), dtype)
    y = torch.empty((rows - 2, 512), dtype=dtype, device="cuda")

    def make(k):
        def run():
            c = torch.zeros((), device="cuda")
            for i in range(k):
                torch.add(x[i % 2: rows - 2 + i % 2], c.to(dtype), out=y)
                c = c + y[i % 7, 0].float() * 1e-12
            return c
        return run

    return _slope("copy  {} {}MB (rd+wr)".format(str(dtype).split(".")[-1], total_mb), make,
                  num_bytes=2 * (rows - 2) * 512 * itemsize)


def matmul_stream(dtype, m_rows, width=512, batch=8):
    """Skinny product: the (M, width) operand streams through the matmul."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    w = _randn((m_rows, width), dtype, seed=1)
    x = _randn((batch, m_rows + 2), dtype, seed=2)

    def make(k):
        def run():
            c = torch.zeros((), device="cuda")
            for i in range(k):
                y = x[:, i % 2: i % 2 + m_rows] @ w
                c = c + torch.tanh(y.float()).sum() * 1e-12
            return c
        return run

    return _slope("matmul stream {} {}MB ({}x{}@..x{})".format(
        str(dtype).split(".")[-1], m_rows * width * itemsize // MB, batch, m_rows, width), make,
        num_bytes=m_rows * width * itemsize)


def kernel_read(total_mb, block_rows, width):
    """The stream-read kernel (B10) over a bf16 array, the scalar chained
    through its output; its output and checksum held against the plain
    version once (rtol 1e-5, atol 1e-5 max|plain|: f32 sums in another
    order; the checksum exactly)."""
    rows = total_mb * MB // (2 * width)
    rows -= rows % block_rows
    x = _randn((rows, width), torch.bfloat16, seed=3)
    s = torch.full((1, 1), 0.25, device="cuda")
    got, words = column_sum_read(x, s, block_rows)
    want, want_words = column_sum_read_plain(x, s, block_rows)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    if checksum_value(words) != checksum_value(want_words):
        raise AssertionError("column_sum_read's checksum differs: not every byte was read")

    def make(k):
        def run():
            c = torch.zeros((1, 1), device="cuda")
            for _ in range(k):
                c = column_sum_read(x, c * 1e-12, block_rows)[0].sum().reshape(1, 1)
            return c
        return run

    return _slope("kernel read bf16 {}MB blk={}x{}".format(rows * width * 2 // MB, block_rows, width),
                  make, num_bytes=rows * width * 2)


def matmul_peak(dtype, n):
    """Chained h <- tanh(h @ w): 2 n^3 FLOPs an iteration."""
    w = _randn((n, n), dtype, seed=4) * (1.0 / n) ** 0.5
    h0 = _randn((n, n), dtype, seed=5)

    def make(k):
        def run():
            h = h0
            for _ in range(k):
                h = torch.tanh(h @ w)
            return h
        return run

    return _slope("matmul peak {} n={}".format(str(dtype).split(".")[-1], n), make, flops=2 * n ** 3)


def sync_latency(reps=20):
    """Host milliseconds of one tiny launch and a synchronise."""
    z = torch.zeros((), device="cuda")
    (z + 1).item()
    t0 = time.perf_counter()
    for _ in range(reps):
        z = z + 1.0
        timing.device_sync()
    ms = (time.perf_counter() - t0) / reps * 1e3
    print("  launch + sync round trip: {:.4f} ms".format(ms), flush=True)
    return ms


def main(argv=None):
    resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = timing.card()
    print("card: {}".format(card), flush=True)
    record = {"card": card, "sync_ms": sync_latency()}
    record["read_f32_gbps"] = read_bw(torch.float32, 256)
    record["read_bf16_gbps"] = read_bw(torch.bfloat16, 256)
    record["copy_f32_gbps"] = copy_bw(torch.float32, 128)
    record["matmul_stream_bf16_gbps"] = matmul_stream(torch.bfloat16, 128 * 1024)
    record["matmul_stream_f32_gbps"] = matmul_stream(torch.float32, 64 * 1024)
    record["kernel_read_gbps"] = {"{}x{}".format(br, w): kernel_read(256, br, w) for br, w in KERNEL_BLOCKS}
    record["matmul_peak_bf16_tflops"] = matmul_peak(torch.bfloat16, 4096)
    record["matmul_peak_f32_tflops"] = matmul_peak(torch.float32, 4096)
    print(json.dumps({"bench_hbm_peak": record}), flush=True)
    return record


if __name__ == "__main__":
    main()
