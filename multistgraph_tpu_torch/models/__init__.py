from multistgraph_tpu_torch.models.astgcn import ASTGCN, build_astgcn, build_mstgcn
from multistgraph_tpu_torch.models.baselines import FNN, RNNModel, Seq2Seq, build_fnn, build_rnn, build_seq2seq
from multistgraph_tpu_torch.models.conv_baselines import GWNET, STGCN, build_gwnet, build_stgcn
from multistgraph_tpu_torch.models.dcrnn import DCRNN, build_dcrnn
from multistgraph_tpu_torch.models.gman import GMAN, build_gman
from multistgraph_tpu_torch.models.graph_baselines import AGCRN, TGCN, build_agcrn, build_tgcn
from multistgraph_tpu_torch.models.mtgnn import MTGNN, build_mtgnn
from multistgraph_tpu_torch.models.multi_atgcn import MultiATGCN, build_multi_atgcn
from multistgraph_tpu_torch.models.registry import MODEL_REGISTRY, get_model
from multistgraph_tpu_torch.models.sparse_atgcn import SparseATGCN, build_sparse_atgcn
from multistgraph_tpu_torch.models.stgncde import STGNCDE, build_stgncde
from multistgraph_tpu_torch.models.stgode import STGODE, build_stgode
from multistgraph_tpu_torch.models.stsgcn import STSGCN, build_stsgcn
from multistgraph_tpu_torch.models.sttn import STTN, build_sttn

__all__ = ["MultiATGCN", "build_multi_atgcn", "SparseATGCN", "build_sparse_atgcn", "MODEL_REGISTRY",
           "get_model", "RNNModel", "build_rnn", "FNN", "build_fnn", "Seq2Seq", "build_seq2seq", "AGCRN",
           "build_agcrn", "TGCN", "build_tgcn", "STGCN", "build_stgcn", "GWNET", "build_gwnet", "DCRNN",
           "build_dcrnn", "ASTGCN", "build_astgcn", "build_mstgcn", "MTGNN", "build_mtgnn", "STSGCN",
           "build_stsgcn", "STTN", "build_sttn", "GMAN", "build_gman", "STGODE", "build_stgode", "STGNCDE",
           "build_stgncde"]
