from multistgraph_tpu_torch.utils.device import resolve_device
from multistgraph_tpu_torch.utils.logging import ensure_dir, get_logger

__all__ = ["ensure_dir", "get_logger", "resolve_device"]
