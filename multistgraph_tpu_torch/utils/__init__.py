from multistgraph_tpu_torch.utils.device import resolve_device
from multistgraph_tpu_torch.utils.logging import ensure_dir, get_logger
from multistgraph_tpu_torch.utils.seeds import set_random_seed

__all__ = ["ensure_dir", "get_logger", "resolve_device", "set_random_seed"]
