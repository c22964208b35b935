"""Model registry + factory: MultiATGCN, SparseATGCN and the model zoo's families.

LSTM and GRU are RNN with their ``rnn_type`` (config/parser.py sets it).
"""

from typing import Callable, Dict

from multistgraph_tpu_torch.models.astgcn import build_astgcn, build_mstgcn
from multistgraph_tpu_torch.models.baselines import build_fnn, build_rnn, build_seq2seq
from multistgraph_tpu_torch.models.conv_baselines import build_gwnet, build_stgcn
from multistgraph_tpu_torch.models.dcrnn import build_dcrnn
from multistgraph_tpu_torch.models.gman import build_gman
from multistgraph_tpu_torch.models.graph_baselines import build_agcrn, build_tgcn
from multistgraph_tpu_torch.models.mtgnn import build_mtgnn
from multistgraph_tpu_torch.models.multi_atgcn import build_multi_atgcn
from multistgraph_tpu_torch.models.sparse_atgcn import build_sparse_atgcn_from_feature
from multistgraph_tpu_torch.models.stgncde import build_stgncde
from multistgraph_tpu_torch.models.stgode import build_stgode
from multistgraph_tpu_torch.models.stsgcn import build_stsgcn
from multistgraph_tpu_torch.models.sttn import build_sttn

MODEL_REGISTRY: Dict[str, Callable] = {
    "MultiATGCN": build_multi_atgcn,
    "SparseATGCN": build_sparse_atgcn_from_feature,
    "RNN": build_rnn,
    "FNN": build_fnn,
    "Seq2Seq": build_seq2seq,
    "AGCRN": build_agcrn,
    "TGCN": build_tgcn,
    "STGCN": build_stgcn,
    "GWNET": build_gwnet,
    "DCRNN": build_dcrnn,
    "ASTGCN": build_astgcn,
    "MSTGCN": build_mstgcn,
    "MTGNN": build_mtgnn,
    "STSGCN": build_stsgcn,
    "STTN": build_sttn,
    "GMAN": build_gman,
    "STGODE": build_stgode,
    "STGNCDE": build_stgncde,
}


def get_model(config, data_feature, device=None, generator=None):
    """Build config['model'] on `device` (CUDA unless "cpu" is asked for)."""
    name = config["model"]
    if name not in MODEL_REGISTRY:
        raise AttributeError("model {} is not registered".format(name))
    return MODEL_REGISTRY[name](config, data_feature, device=device, generator=generator)
