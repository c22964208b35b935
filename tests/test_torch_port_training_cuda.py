"""One training step of the port on the card, with its launch counts.

Marked ``cuda``: it skips without an NVIDIA GPU and imports no JAX, so it
runs on a machine without it:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_training_cuda.py
At a small width (12 nodes, hidden 16) with the flagship's 2 layers and 24
steps, an int8 step launches B2 and B2t 96 times each (2 per step per
layer, forward and reverse) and an f32 step launches B3 4 times forward and
4 times backward (gate_x and upd_x per layer).
"""

import pytest
import torch

from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset
from multistgraph_tpu_torch.executor import get_executor
from multistgraph_tpu_torch.models import get_model
from multistgraph_tpu_torch.ops.layout import force_default_layout
from multistgraph_tpu_torch.ops.node_apply import node_apply_q8, node_apply_q8_t

DATASET = "SYN_TRAIN"


@pytest.mark.cuda
@pytest.mark.parametrize("mode,want", [
    ({"compute_dtype": "bfloat16", "weight_stream_quant": "int8"}, (96, 96, 0, 0)),
    ({"compute_dtype": None}, (0, 0, 4, 4)),
    ({"compute_dtype": "bfloat16"}, (0, 0, 0, 0)),
], ids=["int8", "f32", "bf16"])
def test_cuda_training_step_launches_the_kernels(tmp_path, mode, want):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    raw = str(tmp_path / "raw")
    make_synthetic_dataset(raw, DATASET, num_nodes=12, len_time=24 * 35, seed=3)
    args = {"data_dir": raw, "output_dir": str(tmp_path / "out"), "exp_id": "cuda",
            "cache_dataset": False, "input_window": 24, "output_window": 6, "load_external": True,
            "load_dynamic": False, "add_time_in_day": True, "groupstd": True, "add_static": True,
            "len_closeness": 1, "len_period": 1, "len_trend": 1, "interval_period": 2,
            "interval_trend": 4, "rnn_units": 16, "embed_dim_node": 4, "embed_dim_adj": 4,
            "adjtype": "multi", "adpadj": "bidirection", "batch_size": 8, "num_layers": 2,
            "tensorboard": False, **mode}
    cfg = load_config("traffic_state_pred", "MultiATGCN", DATASET, other_args=args)
    ds = get_dataset(cfg)
    train, _, _ = ds.get_data()
    feature = ds.get_data_feature()
    executor = get_executor(cfg, get_model(cfg, feature), feature)
    batch = executor.batch(train, train.epoch_permutation()[0])
    node_apply_q8.launches = node_apply_q8_t.launches = 0
    force_default_layout.launches = force_default_layout.backward_launches = 0
    loss = executor.train_step(batch)
    torch.cuda.synchronize()
    got = (node_apply_q8.launches, node_apply_q8_t.launches, force_default_layout.launches,
           force_default_layout.backward_launches)
    assert got == want
    assert torch.isfinite(loss)
