from multistgraph_tpu_torch.models.multi_atgcn import MultiATGCN, build_multi_atgcn
from multistgraph_tpu_torch.models.registry import MODEL_REGISTRY, get_model
from multistgraph_tpu_torch.models.sparse_atgcn import SparseATGCN, build_sparse_atgcn

__all__ = ["MultiATGCN", "build_multi_atgcn", "SparseATGCN", "build_sparse_atgcn", "MODEL_REGISTRY",
           "get_model"]
