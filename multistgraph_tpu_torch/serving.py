"""Serving for trained models: bucketed batch predict + HTTP.

Counterpart of multistgraph_tpu/serving.py with the same contract:
  * **Bucketed batching** — a request is right-padded with copies of its
    last row to the next power-of-two batch (capped at ``max_batch``);
    requests above ``max_batch`` are cut into chunks; pad rows are sliced
    off the reply. On CUDA, for a model that declares itself
    ``graph_safe`` (MultiATGCN, SparseATGCN), each bucket has one CUDA
    graph of the forward and the scaler's inverse (executor/graphs.py), as JAX compiles
    one program per bucket: the first request at a bucket runs eagerly on a
    side stream (the warm-up, which answers it) and captures the bucket;
    every later one is a copy of the padded request into the bucket's
    static input and one replay. ``stats()["compiled_buckets"]`` lists the
    captured buckets there, and the buckets served where nothing is
    captured (the CPU).
  * **Model-space in, measurement-space out** — inputs are windowed feature
    tensors (B, T, N, F) as the data layer produces them; outputs are
    scaler-inverse-transformed predictions (B, Tout, N, D), optionally group
    de-z-scored, and clipped at 0 by default.
  * **Stateless HTTP front** — ``POST /predict``, ``GET /health`` on a stdlib
    ThreadingHTTPServer; requests serialize through one lock on the device.

Usage:
    service = PredictService.from_experiment(
        "traffic_state_pred", "MultiATGCN", "SYN_DC", other_args={...})
    y = service.predict(x)                      # numpy in/out
    serve(service, port=8800)                   # blocking HTTP server

Weight-only quantization (``quantize='int8'|'bfloat16'``, ops/quantize.py):
the service stores the model's parameters quantized, releases the module's
own full-precision storage, and dequantizes them inside its forward (the
one each bucket's CUDA graph captures) through
``torch.func.functional_call``, as the JAX service dequantizes inside its
jitted predict. The buffers (graph arrays) and activations are untouched.
"""

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from multistgraph_tpu_torch.executor.graphs import StepGraph, on_side_stream
from multistgraph_tpu_torch.ops.quantize import dequantize_params, quantize_params, quantized_nbytes
from multistgraph_tpu_torch.utils import resolve_device


class PredictService:
    """Wraps a model + scaler into a padded, bucketed predict call."""

    def __init__(self, model: torch.nn.Module, scaler, max_batch: int = 64,
                 ct_visit_mstd=None, clip_negative: bool = True, device=None, quantize: str = None):
        """quantize: None | 'int8' | 'bfloat16', weight-only quantization of
        the model's parameters (module docstring); with it the service owns
        the model, whose own parameter storage it releases."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.quantize = quantize
        self.params = {name: p.detach() for name, p in self.model.named_parameters()}
        if quantize:
            self.params = quantize_params(self.params, mode=quantize)
            for p in self.model.parameters():
                p.data = p.data.new_empty(0)
        self.scaler = scaler
        self.max_batch = max_batch
        self.clip_negative = clip_negative
        # per-node (mean, std) frame for group de-z-scoring, or None
        self._group_mstd = None
        if ct_visit_mstd is not None:
            self._group_mstd = (np.asarray(ct_visit_mstd["All_m"], np.float32),
                                np.asarray(ct_visit_mstd["All_std"], np.float32))
        self._buckets = set()
        self.graphed = self.device.type == "cuda" and getattr(self.model, "graph_safe", False)
        self.graphs = {}  # bucket -> StepGraph of the forward, input "x"
        self._side_stream = torch.cuda.Stream(self.device) if self.graphed else None
        self._lock = threading.Lock()
        self.requests_served = 0

    # -------------------------------------------------------------- factory
    @classmethod
    def from_experiment(cls, task, model_name, dataset_name, config_file=None,
                        other_args=None, max_batch: int = 64, device=None, quantize: str = None):
        """Rebuild config -> dataset -> model and load the weights from
        outputs/<exp_id>/model_cache/<model>_<dataset>.pt, a
        ``torch.save((state_dict, optimizer_state))`` tuple as the reference
        writes its .m cache."""
        from multistgraph_tpu_torch.config import load_config
        from multistgraph_tpu_torch.data import get_dataset
        from multistgraph_tpu_torch.models import get_model

        device = resolve_device(device)
        config = load_config(task, model_name, dataset_name, config_file,
                             saved_model=True, train=False, other_args=other_args)
        dataset = get_dataset(config, device)
        dataset.get_data()
        feature = dataset.get_data_feature()
        model = get_model(config, feature, device=device)
        cache = os.path.join(config.get("output_dir", "./outputs"), str(config.get("exp_id")),
                             "model_cache", "{}_{}.pt".format(model_name, dataset_name))
        state_dict, _ = torch.load(cache, map_location=device, weights_only=True)
        model.load_state_dict(state_dict)
        return cls(model, feature.get("scaler"), max_batch=max_batch,
                   ct_visit_mstd=feature.get("ct_visit_mstd") if config.get("groupstd", False) else None,
                   device=device, quantize=quantize)

    # -------------------------------------------------------------- predict
    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """x: (B, T, N, F) model-space windows; returns (B, Tout, N, D)
        inverse-transformed predictions. B may be anything; requests larger
        than max_batch are chunked."""
        x = np.asarray(x, np.float32)
        if x.ndim != 4:
            raise ValueError("expected (batch, time, nodes, features), got %r" % (x.shape,))
        with self._lock:
            outs = [self._predict_chunk(x[lo: lo + self.max_batch])
                    for lo in range(0, len(x), self.max_batch)]
            self.requests_served += 1
        return np.concatenate(outs, axis=0)

    def _predict_chunk(self, x: np.ndarray) -> np.ndarray:
        n = len(x)
        bucket = self._bucket(n)
        if n < bucket:
            x = np.concatenate([x, np.repeat(x[-1:], bucket - n, axis=0)], axis=0)
        with torch.no_grad():
            pred = self._forward_bucket(bucket, torch.tensor(x))
        out = pred[:n].float().cpu().numpy()
        if self._group_mstd is not None:
            m, s = self._group_mstd
            out = out * s[None, None, :, None] + m[None, None, :, None]
        if self.clip_negative:
            out = np.maximum(out, 0.0)
        return out

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.quantize:
            return self.scaler.inverse_transform(self.model(x))
        # dequantized here, inside the forward a bucket's graph captures
        full = dequantize_params(self.params)
        return self.scaler.inverse_transform(torch.func.functional_call(self.model, full, (x,)))

    def _forward_bucket(self, bucket: int, x: torch.Tensor) -> torch.Tensor:
        """Inverse-transformed predictions for the padded request `x` (a CPU
        tensor of `bucket` rows): eager where nothing is captured, else a
        replay of the bucket's graph, captured at its first request."""
        self._buckets.add(bucket)
        if not self.graphed:
            return self._forward(x.to(self.device))
        graph = self.graphs.get(bucket)
        if graph is not None:
            return graph.run(x=x)
        static_x = x.to(self.device)
        pred = on_side_stream(lambda: self._forward(static_x), self._side_stream)
        self.graphs[bucket] = StepGraph(lambda: self._forward(static_x), inputs={"x": static_x})
        return pred

    def stats(self) -> dict:
        return {
            "requests_served": self.requests_served,
            "compiled_buckets": sorted(self._buckets),
            "max_batch": self.max_batch,
            "device": self.device.type,
            "group_destandardize": self._group_mstd is not None,
            "quantize": self.quantize,
            "param_bytes": quantized_nbytes(self.params),
        }


class _Handler(BaseHTTPRequestHandler):
    service = None  # injected by make_server()

    def _reply(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/health":
            self._reply(200, dict(self.service.stats(), status="ok"))
        else:
            self._reply(404, {"error": "unknown path %s" % self.path})

    def do_POST(self):
        if self.path != "/predict":
            self._reply(404, {"error": "unknown path %s" % self.path})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length))
            y = self.service.predict(np.asarray(req["x"], np.float32))
            self._reply(200, {"prediction": y.tolist(), "shape": list(y.shape)})
        except Exception as exc:  # noqa: BLE001 — report, keep serving
            self._reply(400, {"error": str(exc)})

    def log_message(self, fmt, *args):  # quiet by default
        pass


def make_server(service: PredictService, port: int = 0, host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """An HTTP server bound to the service, not yet serving; port=0 picks a
    free port (server.server_address[1])."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def serve(service: PredictService, port: int = 8800, host: str = "0.0.0.0"):
    """Blocking HTTP server: POST /predict {"x": [...]}, GET /health."""
    server = make_server(service, port, host)
    print("serving on {}:{}".format(*server.server_address), flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
