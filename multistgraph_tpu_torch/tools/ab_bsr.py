"""A/B timing of two versions of the block-sparse kernels (B4/B6, B5) on one GPU.

Builds ``csrc/bsr_spmm.cu`` and ``csrc/sampled_matmul.cu`` of this
checkout and of another one (e.g. the parent commit unpacked with ``git
archive``) with the port's nvcc flags, one nvcc each, all started
together, loads them with ctypes and times them in turns, base, new, new,
base, for several rounds, on the 49,152-node graph of the sparse path
(4,946 tiles of 128x128, ``random_spatial_graph(49152, 16, seed=0)``):
  * B4/B6 f32 forward at every width the path gives it (F = 16, 24, 64,
    128, 1536) and on the block-transposed graph of the backward's dX (F =
    128, 1536: hub rows of 384 tiles);
  * B4/B6 bf16 (f32 sums) forward at F = 12, 16, 24, 64, 128, 768, 1536
    and transposed at F = 128, 1536;
  * B5 (``sampled_matmul``) at every width the path gives it (d = 16, 24,
    128, 1536), f32 and bf16 operands.
B5 is called through the C interface its source has: the f32 entry takes
(nnz, d) where the source has no ``sampled_matmul_f32_blocks``, else
(nnz, d, n_a, n_b, fault) as the bf16 entry does. B4/B6 likewise: one thread
block per row block (``bsr_spmm_fwd(values, row_ptr, col_of, x, out,
...)``), or the segment schedule of ``ops/spmm.bsr_schedule`` with its
workspace and a counter array zeroed before each call where the schedule
may split a row, as the wrapper does (``bsr_spmm_fwd(values, col_of, x,
out, schedule, ws, counters, ...)``; the zeroing is timed with the call).
The schedules are built as the model builds them, once, with their
workspace counted (none where no row is split). ``--segment-tiles`` times
the new version on schedules of other segment lengths beside the module's
(``ops/spmm.SEGMENT_TILES``). The unchanged layout-copy kernel (B3) is
timed in each round as a control for drift of the card. Before timing,
each output is held against the base's: rtol 1e-5 with atol 1e-5
max|base| for f32 operands, 4e-5 for bf16 ones (chip_smoke.py's bounds for
B4/B6: the same products summed in another order; B5's bf16 tiles are
rounded from such sums). Times are CUDA-event medians with
the L2 flushed before each call (``tools.timing.event_ms``, as
chip_smoke.py takes them).

Run from the repository root:
    python -m multistgraph_tpu_torch.tools.ab_bsr --base <dir of the other checkout>
``--only B5`` keeps B5's rows (``--only`` matches kernel and shape).
Prints one JSON line per (version, kernel, shape) with the median over
rounds, and the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import tempfile

import torch

from multistgraph_tpu_torch.ops import _cuda, spmm
from multistgraph_tpu_torch.ops.bsr import random_spatial_graph
from multistgraph_tpu_torch.ops.layout import force_default_layout
from multistgraph_tpu_torch.tools.timing import card, event_ms

NODES, DEGREE = 49152, 16
WIDTHS = {torch.float32: ((16, 24, 64, 128, 1536), (128, 1536)),
          torch.bfloat16: ((12, 16, 24, 64, 128, 768, 1536), (128, 1536))}
B5_WIDTHS = (16, 24, 128, 1536)   # forward scores, then the adaptive dV at the SpMM widths
HOLD_REL = {torch.float32: 1e-5, torch.bfloat16: 4e-5}
_P, _I = ctypes.c_void_p, ctypes.c_int
SOURCES = ("bsr_spmm", "sampled_matmul")


class Version:
    """bsr_spmm.cu and sampled_matmul.cu of one checkout, called through the
    interfaces their sources have."""

    def __init__(self, root, out_dir, tag):
        self.root, self.builds = root, {}
        for name in SOURCES:
            lib_path = os.path.join(out_dir, "lib{}-{}.so".format(name, tag))
            source = os.path.join(root, "multistgraph_tpu_torch", "csrc", name + ".cu")
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib_path, source]
            self.builds[name] = (lib_path, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                            text=True))

    def load(self):
        libs = {}
        for name, (lib_path, proc) in self.builds.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed for {}.cu of {}:\n{}".format(name, self.root, out))
            libs[name] = ctypes.CDLL(lib_path)
        sampled = libs["sampled_matmul"]
        # the f32 entry of a source with sampled_matmul_f32_blocks takes the bf16 entry's ints
        self.b5_ints = 5 if hasattr(sampled, "sampled_matmul_f32_blocks") else 2
        self.b5 = {}
        for entry, bf16 in (("sampled_matmul_fwd", False), ("sampled_matmul_bf16", True)):
            fn = getattr(sampled, entry)
            fn.argtypes = [_P] * 5 + [_I] * (5 if bf16 else self.b5_ints) + [_P]
            fn.restype = ctypes.c_int
            self.b5[bf16] = fn
        lib = libs["bsr_spmm"]
        self.segmented = hasattr(lib, "bsr_spmm_feature_tile")
        self.fns = {}
        for entry, bf16 in (("bsr_spmm_fwd", False), ("bsr_spmm_bf16", True)):
            fn = getattr(lib, entry)
            if self.segmented:
                fn.argtypes = [_P] * 7 + [_I] * 6 + [_P]
            else:
                fn.argtypes = [_P] * 5 + [_I] * (5 if bf16 else 2) + [_P]
            fn.restype = ctypes.c_int
            self.fns[bf16] = fn
        if self.segmented:
            self.tile = lib.bsr_spmm_feature_tile
            self.tile.argtypes, self.tile.restype = [_I, _I], _I
        return self

    def prepare_b5(self, case):
        """The call of this version's B5 on `case` (a, bt, row_of, col_of, out)."""
        a, bt, row, col, out = case
        bf16 = a.dtype == torch.bfloat16
        fn, nnz, d = self.b5[bf16], row.shape[0], a.shape[1]
        ints = (nnz, d, a.shape[0], bt.shape[0], 0)[:5 if bf16 else self.b5_ints]
        ptrs = [t.data_ptr() for t in case]
        stream = torch.cuda.current_stream().cuda_stream
        return lambda: _check(fn(*ptrs, *ints, stream))

    def prepare(self, case, schedule):
        """The call of this version's B4/B6 on `case`, with its workspace allocated once."""
        values, row_ptr, col, x, out, nb = case
        bf16 = x.dtype == torch.bfloat16
        fn, feat, nnz = self.fns[bf16], x.shape[1], values.shape[0]
        stream = torch.cuda.current_stream().cuda_stream
        if not self.segmented:
            ints = (nb, feat, nnz, x.shape[0], 0) if bf16 else (nb, feat)
            ptrs = [t.data_ptr() for t in (values, row_ptr, col, x, out)]
            return lambda: _check(fn(*ptrs, *ints, stream))
        tile = self.tile(feat, int(bf16))
        tiles = -(-feat // tile)
        seg = schedule.segments
        ws = counters = None
        if schedule.ws_slots:
            ws = torch.empty(schedule.ws_slots * tiles * 128 * tile, device="cuda")
            counters = torch.zeros(nb * tiles, dtype=torch.int32, device="cuda")
        ptrs = [None if t is None else t.data_ptr() for t in (values, col, x, out, seg, ws, counters)]
        ints = (nb, feat, nnz, x.shape[0], seg.shape[0], 0)

        def call():
            if counters is not None:
                counters.zero_()
            _check(fn(*ptrs, *ints, stream))

        return call


def _check(rc):
    if rc != 0:
        raise RuntimeError("kernel launch failed: CUDA error {}".format(rc))


def _cases(g):
    """[(kernel, shape, (values, row_ptr, col, x, out, out_blocks))] at the
    widths of WIDTHS, forward and transposed, f32 then bf16; then [("B5",
    shape, (a, bt, row_of, col_of, out))] at B5_WIDTHS, f32 then bf16."""
    graph, _ = random_spatial_graph(NODES, DEGREE, seed=0)
    nb, n_pad = graph.num_row_blocks, graph.padded_nodes
    values = torch.from_numpy(graph.values).cuda()
    row = torch.from_numpy(graph.row_of).cuda()
    col = torch.from_numpy(graph.col_of).cuda()
    cases = []
    for dtype, (fwd, dx) in WIDTHS.items():
        v = values.to(dtype)
        v_t, r_t, c_t = spmm.bsr_transpose(v, row, col, nb)
        for what, (vv, rr, cc), widths in (("", (v, row, col), fwd), (" transposed", (v_t, r_t, c_t), dx)):
            ptr = spmm.row_ptr_of(rr, nb)
            for feat in widths:
                x = torch.randn(n_pad, feat, generator=g, device="cuda").to(dtype)
                out = torch.empty(n_pad, feat, device="cuda")
                cases.append(("B4/B6" + what, "F={} {}".format(feat, str(dtype)[6:]), (vv, ptr, cc, x, out, nb)))
    for dtype in WIDTHS:
        for d in B5_WIDTHS:
            a, bt = (torch.randn(n_pad, d, generator=g, device="cuda").to(dtype) for _ in range(2))
            out = torch.empty(row.shape[0], 128, 128, device="cuda", dtype=dtype)
            cases.append(("B5", "d={} {}".format(d, str(dtype)[6:]), (a, bt, row, col, out)))
    return cases


def _hold(got, ref, rel, what):
    bound = rel * (ref.abs() + ref.abs().max())
    if not bool(((got - ref).abs() <= bound).all()):
        raise AssertionError("{}: the new version's output differs from the base's".format(what))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10, help="timed calls per sample")
    ap.add_argument("--segment-tiles", type=int, nargs="*", default=[],
                    help="also time the new version on schedules of these segment lengths")
    ap.add_argument("--only", default="", help="time only the rows whose kernel or shape holds this")
    cli = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [c for c in _cases(g) if cli.only in c[0] + " " + c[1]]
    view = torch.randn(24, 16, 237, 192, generator=g, device="cuda")[..., :128]
    samples = {}
    with tempfile.TemporaryDirectory() as tmp:
        versions = {"base": Version(cli.base, tmp, "base"), "new": Version(here, tmp, "new")}
        versions = {k: v.load() for k, v in versions.items()}
        schedules = {}   # (segment tiles, row_ptr) per case, built once
        calls = {}
        for kernel, shape, case in cases:
            if kernel == "B5":
                out = case[4]
                for name, version in versions.items():
                    fn = version.prepare_b5(case)
                    fn()
                    torch.cuda.synchronize()
                    if name == "base":
                        ref = out.float().clone()
                    else:
                        _hold(out.float(), ref, HOLD_REL[out.dtype], "{} {} {}".format(name, kernel, shape))
                    calls[(name, kernel, shape)] = fn
                del ref
                continue
            values, ptr = case[0], case[1]
            for seg_tiles in [spmm.SEGMENT_TILES] + cli.segment_tiles:
                # as the model builds them once, the workspace counted
                schedules[(kernel, shape, seg_tiles)] = spmm.bsr_schedule(ptr, values.shape[0], seg_tiles, exact=True)
            ref = None
            for name, version in versions.items():
                variants = [spmm.SEGMENT_TILES] + (cli.segment_tiles if name == "new" else [])
                for seg_tiles in variants:
                    label = name if seg_tiles == spmm.SEGMENT_TILES else "{} S={}".format(name, seg_tiles)
                    fn = version.prepare(case, schedules[(kernel, shape, seg_tiles)])
                    fn()
                    torch.cuda.synchronize()
                    if ref is None:
                        ref = case[4].clone()
                    else:
                        _hold(case[4], ref, HOLD_REL[case[3].dtype], "{} {} {}".format(label, kernel, shape))
                    calls[(label, kernel, shape)] = fn
            del ref
        labels = sorted({k[0] for k in calls}, key=lambda k: (k != "base", k))
        order = labels + labels[::-1]   # base, new, ..., ..., new, base
        for _ in range(cli.rounds):
            for label in order:
                for (lab, kernel, shape), fn in calls.items():
                    if lab == label:
                        samples.setdefault((label, kernel, shape), []).append(event_ms(fn, reps=cli.reps))
                samples.setdefault(("control", "B3", "gate_x (24,16,237,128) f32"), []).append(
                    event_ms(lambda: force_default_layout(view)))
    name = card()
    for (version, kernel, shape), ms in samples.items():
        print(json.dumps({"version": version, "kernel": kernel, "shape": shape,
                          "median_us": statistics.median(ms) * 1e3, "samples_us": [m * 1e3 for m in ms],
                          "card": name}), flush=True)


if __name__ == "__main__":
    main()
