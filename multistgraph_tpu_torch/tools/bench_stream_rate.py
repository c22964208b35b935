"""A sweep of concurrent streams x block size through the stream-read kernel.

Counterpart of tools/bench_stream_rate.py, which calls itself superseded:
on the TPU its readings were latency artifacts, and it was kept for the
relative block-size comparisons of a grid pipeline that gave each input
its own double-buffered DMA. On the card it is a sweep of concurrent
streams, nothing more: each configuration reads 512 MB split over n
arrays of shape (grid, rows, 512) bf16, one block of rows being the
block size, through the stream-read kernel's rate mode
(``ops.stream_read.stream_rate_read``, csrc/stream_read.cu), which reads
every byte and writes s + the sum of the arrays' last-block first rows.
The kernel tiles its own way, so the block size only shapes the arrays.
The read ceiling itself is ``bench_hbm_peak``'s.

Each reading is REPEAT chained calls (each output's mean is the next
call's scalar) between CUDA events, the median of 5, divided by REPEAT.
Unlike the TPU bench, a configuration that fails is not caught.

Run from the repository root on the card:
    python -m multistgraph_tpu_torch.tools.bench_stream_rate
It prints GB/s with the card's name and power limit and one JSON line; it
raises without a CUDA device.
"""

import json

import torch

from multistgraph_tpu_torch.ops.stream_read import checksum_value, stream_rate_read, stream_rate_read_plain
from multistgraph_tpu_torch.tools import timing
from multistgraph_tpu_torch.utils.device import resolve_device

MB = 1024 * 1024
TOTAL_MB = 512          # bytes read per call, over all streams
REPEAT = 8
CONFIGS = ((1, 1), (1, 2), (1, 4), (1, 8), (2, 2), (2, 4), (4, 1), (4, 2), (8, 1))  # (streams, block MB)


def make(n_streams, block_mb, seed=0):
    """n_streams arrays of (grid, rows_per_block, 512) bf16, TOTAL_MB in all;
    the call is held against the plain version (bit-identical: the same
    f32 adds in the same order; the checksum exactly)."""
    rows_per_block = block_mb * MB // (2 * 512)
    total_rows = TOTAL_MB * MB // (2 * 512 * n_streams)
    grid = total_rows // rows_per_block
    g = torch.Generator(device="cuda").manual_seed(seed)
    arrays = [torch.randn((grid, rows_per_block, 512), generator=g, device="cuda").to(torch.bfloat16)
              for _ in range(n_streams)]
    s = torch.full((1, 1), 0.5, device="cuda")
    got, words = stream_rate_read(arrays, s)
    want, want_words = stream_rate_read_plain(arrays, s)
    if not torch.equal(got, want) or checksum_value(words) != checksum_value(want_words):
        raise AssertionError("stream_rate_read differs from its plain version at {} streams".format(n_streams))
    return arrays, grid


def rate(n_streams, block_mb):
    arrays, grid = make(n_streams, block_mb)

    def chain():
        c = torch.zeros((1, 1), device="cuda")
        for _ in range(REPEAT):
            c = stream_rate_read(arrays, c)[0].mean().reshape(1, 1) * 1e-6
        return c

    ms = timing.event_ms(chain, reps=5, flush=False) / REPEAT
    gbps = TOTAL_MB * MB / (ms * 1e-3) / 1e9
    print("  streams={:2d} block={:3d}MB grid={:4d}: {:7.1f} GB/s ({:.3f} ms)".format(
        n_streams, block_mb, grid, gbps, ms), flush=True)
    return gbps


def main(argv=None):
    resolve_device(None)
    card = timing.card()
    print("card: {}".format(card), flush=True)
    record = {"card": card, "gbps": {"{}x{}MB".format(n, mb): rate(n, mb) for n, mb in CONFIGS}}
    print(json.dumps({"bench_stream_rate": record}), flush=True)
    return record


if __name__ == "__main__":
    main()
