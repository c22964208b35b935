from multistgraph_tpu_torch.models.multi_atgcn import MultiATGCN, build_multi_atgcn
from multistgraph_tpu_torch.models.registry import MODEL_REGISTRY, get_model

__all__ = ["MultiATGCN", "build_multi_atgcn", "MODEL_REGISTRY", "get_model"]
