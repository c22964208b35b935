"""A/B timing of two versions of the int8 node-apply kernel (B2) on one GPU.

Builds ``csrc/node_apply_q8.cu`` of this checkout and of another one (e.g.
the parent commit unpacked with ``git archive``) with the port's nvcc flags,
loads both with ctypes (they share one C interface, ``node_apply_q8_fwd``)
and times them in turns, base, new, new, base, for several rounds, at the
serving and training shapes (N=237, KI=320, gate O=128 and update O=64, at
batches 1, 4 and 16). The unchanged layout-copy kernel (B3) is timed in each
round as a control for drift of the card. Times are CUDA-event medians with
the L2 flushed before each call (``tools.timing.event_ms``, as chip_smoke.py
takes them).

Run from the repository root:
    python -m multistgraph_tpu_torch.tools.ab_node_apply --base <dir of the other checkout>
Prints one JSON line per (version, shape) with the median over rounds, and
the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import tempfile

import torch

from multistgraph_tpu_torch.ops import _cuda
from multistgraph_tpu_torch.ops.layout import force_default_layout
from multistgraph_tpu_torch.ops.node_apply import _pad_nodes, quantize_node_weights
from multistgraph_tpu_torch.tools.timing import card, event_ms

N, KI = 237, 320
SHAPES = [(b, cell, o) for b in (1, 4, 16) for cell, o in (("gate", 128), ("update", 64))]


def _load(source: str, out_dir: str, tag: str):
    lib_path = os.path.join(out_dir, "lib{}.so".format(tag))
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib_path, source], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(lib_path).node_apply_q8_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=3)
    cli = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    rel = os.path.join("multistgraph_tpu_torch", "csrc", "node_apply_q8.cu")
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for b, cell, o in SHAPES:
        hh = torch.randn(N, b, KI, generator=g, device="cuda").to(torch.bfloat16)
        wq, s = quantize_node_weights(torch.randn(N, KI, o, generator=g, device="cuda") * 0.1)
        cases[(b, cell)] = (hh, _pad_nodes(wq, 0, 256), _pad_nodes(s, 0, 256),
                            torch.empty(N, b, o, device="cuda"))
    view = torch.randn(24, 16, N, 192, generator=g, device="cuda")[..., :128]
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"base": _load(os.path.join(cli.base, rel), tmp, "base"),
               "new": _load(os.path.join(here, rel), tmp, "new")}
        stream = torch.cuda.current_stream().cuda_stream
        samples = {}
        for _ in range(cli.rounds):
            for version in ("base", "new", "new", "base"):
                for (b, cell), (hh, wq, s, out) in cases.items():
                    def call(fn=fns[version], hh=hh, wq=wq, s=s, out=out, b=b):
                        rc = fn(hh.data_ptr(), wq.data_ptr(), s.data_ptr(), out.data_ptr(),
                                N, b, KI, wq.shape[2], stream)
                        if rc != 0:
                            raise RuntimeError("launch failed: CUDA error {}".format(rc))
                    samples.setdefault((version, b, cell), []).append(event_ms(call))
                samples.setdefault(("control", "B3 gate_x", ""), []).append(
                    event_ms(lambda: force_default_layout(view)))
    name = card()
    for (version, b, cell), ms in samples.items():
        print(json.dumps({"version": version, "batch": b, "cell": cell, "median_us": statistics.median(ms) * 1e3,
                          "samples_us": [m * 1e3 for m in ms], "card": name}), flush=True)


if __name__ == "__main__":
    main()
