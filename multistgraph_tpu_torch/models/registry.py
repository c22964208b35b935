"""Model registry + factory: MultiATGCN and SparseATGCN."""

from typing import Callable, Dict

from multistgraph_tpu_torch.models.multi_atgcn import build_multi_atgcn
from multistgraph_tpu_torch.models.sparse_atgcn import build_sparse_atgcn_from_feature

MODEL_REGISTRY: Dict[str, Callable] = {
    "MultiATGCN": build_multi_atgcn,
    "SparseATGCN": build_sparse_atgcn_from_feature,
}


def get_model(config, data_feature, device=None, generator=None):
    """Build config['model'] on `device` (CUDA unless "cpu" is asked for)."""
    name = config["model"]
    if name not in MODEL_REGISTRY:
        raise AttributeError("model {} is not registered".format(name))
    return MODEL_REGISTRY[name](config, data_feature, device=device, generator=generator)
