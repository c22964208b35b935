"""The port runs without JAX, flax, pandas and the JAX package.

A fresh interpreter blocks the top-level modules ``jax``, ``jaxlib``,
``flax``, ``pandas`` and ``multistgraph_tpu`` (by exact name:
``multistgraph_tpu_torch`` starts with ``multistgraph_tpu`` and must stay
importable), imports every module of the port, writes a small synthetic
dataset with the port's generator, and serves one CPU predict through
``from_experiment``.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent(r"""
    import importlib, importlib.abc, os, pkgutil, sys

    BLOCKED = {"jax", "jaxlib", "flax", "pandas", "multistgraph_tpu"}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import of " + name)
            return None

    sys.meta_path.insert(0, Block())

    import multistgraph_tpu_torch
    for info in pkgutil.walk_packages(multistgraph_tpu_torch.__path__, "multistgraph_tpu_torch."):
        importlib.import_module(info.name)

    import numpy as np
    import torch
    from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset
    from multistgraph_tpu_torch.serving import PredictService
    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.data import get_dataset
    from multistgraph_tpu_torch.models import get_model

    work = sys.argv[1]
    make_synthetic_dataset(os.path.join(work, "raw"), "SYN", num_nodes=6, len_time=24 * 36, seed=1)
    args = {"data_dir": os.path.join(work, "raw"), "cache_dir": os.path.join(work, "cache"),
            "output_dir": os.path.join(work, "out"), "exp_id": "iso", "cache_dataset": False,
            "len_closeness": 1, "len_period": 1, "len_trend": 1, "interval_period": 2,
            "interval_trend": 4, "input_window": 24, "output_window": 6, "load_external": True,
            "load_dynamic": False, "add_time_in_day": True, "groupstd": True,
            "compute_dtype": "bfloat16", "weight_stream_quant": "int8",
            "batch_size": 4, "rnn_units": 8, "embed_dim_node": 3, "embed_dim_adj": 3}
    cfg = load_config("traffic_state_pred", "MultiATGCN", "SYN", other_args=args)
    ds = get_dataset(cfg, device="cpu")
    _, _, test = ds.get_data()
    model = get_model(cfg, ds.get_data_feature(), device="cpu")
    cache = os.path.join(work, "out", "iso", "model_cache", "MultiATGCN_SYN.pt")
    os.makedirs(os.path.dirname(cache))
    torch.save((model.state_dict(), {}), cache)
    service = PredictService.from_experiment("traffic_state_pred", "MultiATGCN", "SYN",
                                             other_args=args, device="cpu")
    y = service.predict(test.x[:3].numpy())
    assert y.shape == (3, 6, 6, 1) and np.isfinite(y).all(), y.shape
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print("ISOLATED_OK")
""")


def test_port_imports_and_serves_without_jax_pandas_or_the_jax_package(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path)], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED_OK" in proc.stdout
