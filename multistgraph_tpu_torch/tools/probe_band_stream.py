"""The band-stream probes on the card: a windowed batched product and the slab band SpMM.

Counterpart of tools/probe_band_stream.py, which probes on a TPU whether a
slab-granular band SpMM kernel can be built (one product per output row
block against a contiguous window of the padded x) and times it. The port
keeps the tool's outputs, not its Mosaic mechanics:

  P1  a batched product (C,b,W) @ (C,W,F) in one kernel, C=4, b=128,
      W=384, F=128, f32 (``ops.band_probe.window_dot`` on the windows of
      the stacked operand), checked against einsum('cbw,cwf->cbf') at
      rtol = atol = 1e-3, as the JAX tool checks it;
  P3  v (128, 640) @ x[1:6].reshape(640, 128), x (8, 128, 128), f32 (the
      same kernel on one window), checked the same way;
  P2  the slab band product at the 1M point, R = 8192 row blocks (1,048,576
      nodes), radius 2 (W = 640), F = 128, bf16 operands, f32 out
      (``ops.band_probe.band_slab``, chunk_rows 8), per-row and batched,
      each checked over the whole output against its plain version (the
      stacked einsum in f32) at rtol 1e-5 with atol 1e-5 times the largest
      |plain| (the same exact products summed in another order); beside
      them the plain version's time and one library call, a bf16 torch.bmm
      of the packed rows against overlapping windows of xp (as_strided);
  P4  the model's kernels at the same point, bf16: band_slab at chunk_rows
      8 and 16, pack_band_rows on the device followed by B8, spmm_band on
      the planes (B7), spmm_band_packed (B8), and the library call.

Each probe prints "[name] OK|FAIL note" to stderr, and times are ms per
call by tools/timing.slope_time; the P2 times are printed as a dict, as the
JAX tool prints them, then one JSON record with the card's name and power
limit. The inputs of P1 and P3 are the JAX tool's (numpy seeds 0 and 1);
those of P2 and P4 are drawn on the card from torch generators seeded 2 and
3 (numpy would take tens of seconds for the 1.34 GB of packed rows).

Run from the repository root:
    python -m multistgraph_tpu_torch.tools.probe_band_stream            (on the card)
    python -m multistgraph_tpu_torch.tools.probe_band_stream --small    (CPU: P1, P3 and a
                                                                          4-row-block P2, plain versions)
Without a card and without --small it raises.
"""

import argparse
import json
import sys

import numpy as np
import torch

from multistgraph_tpu_torch.ops import band
from multistgraph_tpu_torch.ops.band_probe import band_slab, band_slab_plain, window_dot
from multistgraph_tpu_torch.tools import timing
from multistgraph_tpu_torch.utils.device import resolve_device

B = 128
RADIUS = 2
FULL_ROW_BLOCKS, SMALL_ROW_BLOCKS = 8192, 4
FEAT = 128
TRIPS = (4, 8, 16, 32)


def _report(name, ok, note=""):
    print("[{}] {} {}".format(name, "OK" if ok else "FAIL", note), file=sys.stderr, flush=True)


def _ms(device, fn):
    """ms per call by the slope method on the card; None on the CPU."""
    if device.type != "cuda":
        return None

    def make(k):
        def run():
            for _ in range(k):
                fn()
        return run

    return timing.slope_time(make, trips=TRIPS)[0] * 1e3


def _note(ms):
    return "not timed (CPU)" if ms is None else "{:.4f} ms".format(ms)


def _within(got, want, rtol, atol):
    return bool(torch.isfinite(got).all() and ((got - want).abs() <= atol + rtol * want.abs()).all())


def probe_batched_dot(device):
    """P1: (C,b,W) @ (C,W,F) as one windowed product over the stacked operand."""
    c, w, f = 4, 3 * B, B
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.normal(size=(c, B, w)).astype(np.float32)).to(device)
    x = torch.from_numpy(rng.normal(size=(c, w, f)).astype(np.float32)).to(device)
    flat = x.reshape(c * w, f)
    starts = [i * w for i in range(c)]
    before = window_dot.launches
    out = window_dot(v, flat, starts)
    want = torch.einsum("cbw,cwf->cbf", v, x)
    ok = _within(out, want, 1e-3, 1e-3)
    ms = _ms(device, lambda: window_dot(v, flat, starts))
    _report("P1 batched-dot", ok, _note(ms))
    return {"ok": ok, "ms": ms, "max_abs_err": (out - want).abs().max().item(),
            "launches": window_dot.launches - before}


def probe_slice_reshape(device):
    """P3: v @ x[1:6].reshape(640, 128), the window of rows 128..767 of x."""
    r, f = RADIUS, B
    w = (2 * r + 1) * B
    rng = np.random.default_rng(1)
    xs = torch.from_numpy(rng.normal(size=(8, B, f)).astype(np.float32)).to(device)
    v = torch.from_numpy(rng.normal(size=(B, w)).astype(np.float32)).to(device)
    flat, vv = xs.reshape(8 * B, f), v[None]
    before = window_dot.launches
    out = window_dot(vv, flat, [B])[0]
    want = v @ xs[1:1 + 2 * r + 1].reshape(w, f)
    ok = _within(out, want, 1e-3, 1e-3)
    ms = _ms(device, lambda: window_dot(vv, flat, [B]))
    _report("P3 slice-reshape", ok, _note(ms))
    return {"ok": ok, "ms": ms, "max_abs_err": (out - want).abs().max().item(),
            "launches": window_dot.launches - before}


def _windows(xp, nb, width):
    """(R, W, F) view: the overlapping windows of the padded x, one per row block."""
    feat = xp.shape[2]
    return xp.as_strided((nb, width, feat), (B * feat, feat, 1))


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device=gen.device).to(torch.bfloat16)


def probe_streams(device, r_blocks):
    """P2: the slab band product per-row and batched (chunk_rows 8), each
    against its plain version over the whole output, with the plain
    version's and one library call's times."""
    n_off, w = 2 * RADIUS + 1, (2 * RADIUS + 1) * B
    gen = torch.Generator(device=device).manual_seed(2)
    v_pack = _randn(gen, r_blocks, B, w)
    xp = _randn(gen, r_blocks + 2 * RADIUS, B, FEAT)
    want = band_slab_plain(v_pack, xp, RADIUS)
    atol = 1e-5 * want.abs().max().item()
    results, record = {}, {}
    for name, batched in (("per-c dots", False), ("batched dot", True)):
        before = (band_slab.launches, band_slab.batched_launches)
        out = band_slab(v_pack, xp, RADIUS, chunk_rows=8, batched=batched)
        ok = _within(out, want, 1e-5, atol)
        err = (out - want).abs().max().item()
        del out
        ms = _ms(device, lambda b=batched: band_slab(v_pack, xp, RADIUS, chunk_rows=8, batched=b))
        results[name] = ms
        record[name] = {"ok": ok, "ms": ms, "max_abs_err": err, "tolerance": "rtol 1e-5, atol 1e-5*max|plain|",
                        "launches": (band_slab.launches - before[0]) + (band_slab.batched_launches - before[1])}
        _report("P2 {}".format(name), ok, _note(ms))
    del want
    results["einsum"] = record["plain_ms"] = _ms(device, lambda: band_slab_plain(v_pack, xp, RADIUS))
    _report("P2 einsum (the plain version, f32)", True, _note(results["einsum"]))
    xw = _windows(xp, r_blocks, w)
    results["library"] = record["library_ms"] = _ms(device, lambda: torch.bmm(v_pack, xw))
    record["library"] = "torch.bmm(packed rows, overlapping windows of xp) in bf16"
    _report("P2 library bmm", True, _note(results["library"]))
    record["shape"] = {"row_blocks": r_blocks, "radius": RADIUS, "feat": FEAT, "chunk_rows": 8,
                       "dtype": "bfloat16", "v_pack_bytes": v_pack.numel() * 2, "xp_bytes": xp.numel() * 2}
    print({k: v for k, v in results.items()}, flush=True)
    return record


def probe_integration(device, r_blocks):
    """P4: the model's band kernels at the same point, bf16."""
    n_off = 2 * RADIUS + 1
    offs = tuple(range(-RADIUS, RADIUS + 1))
    gen = torch.Generator(device=device).manual_seed(3)
    v_diag = _randn(gen, n_off, r_blocks, B, B)
    v_pack = band.pack_band_rows(v_diag, offs, RADIUS)
    xp = _randn(gen, r_blocks + 2 * RADIUS, B, FEAT)
    x_flat = xp[RADIUS:RADIUS + r_blocks].reshape(r_blocks * B, FEAT).contiguous()
    xw = _windows(xp, r_blocks, n_off * B)
    record = {}
    for name, fn in (
            ("band_slab cr=8 (pre-packed)", lambda: band_slab(v_pack, xp, RADIUS, chunk_rows=8)),
            ("band_slab cr=16 (pre-packed)", lambda: band_slab(v_pack, xp, RADIUS, chunk_rows=16)),
            ("pack_band_rows on the device + B8",
             lambda: band.band_spmm_packed(band.pack_band_rows(v_diag, offs, RADIUS), RADIUS, x_flat)),
            ("spmm_band on the planes (B7)", lambda: band.spmm_band(v_diag, offs, x_flat)),
            ("spmm_band_packed (B8)", lambda: band.spmm_band_packed(v_pack, RADIUS, x_flat)),
            ("library bmm", lambda: torch.bmm(v_pack, xw))):
        record[name] = _ms(device, fn)
        _report("P4 {}".format(name), True, _note(record[name]))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true", help="CPU: P1, P3 and a 4-row-block P2, plain versions")
    cli = ap.parse_args(argv)
    device = torch.device("cpu") if cli.small else resolve_device(None)
    record = {"card": timing.card() if device.type == "cuda" else None, "device": str(device)}
    record["P1"] = probe_batched_dot(device)
    record["P3"] = probe_slice_reshape(device)
    r_blocks = SMALL_ROW_BLOCKS if cli.small else FULL_ROW_BLOCKS
    record["P2"] = probe_streams(device, r_blocks)
    if not cli.small:
        record["P4"] = probe_integration(device, r_blocks)
    record["ok"] = all(record[p]["ok"] for p in ("P1", "P3")) and all(
        record["P2"][v]["ok"] for v in ("per-c dots", "batched dot"))
    print("probes done p1={} p3={}".format(record["P1"]["ok"], record["P3"]["ok"]), flush=True)
    print(json.dumps({"probe_band_stream": record}), flush=True)
    return record


if __name__ == "__main__":
    main()
