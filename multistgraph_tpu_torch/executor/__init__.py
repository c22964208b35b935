from multistgraph_tpu_torch.executor.executor import EXECUTOR_REGISTRY, TrafficStateExecutor, get_executor
from multistgraph_tpu_torch.executor.optimizers import build_lr_scheduler, build_optimizer

__all__ = [
    "EXECUTOR_REGISTRY",
    "TrafficStateExecutor",
    "get_executor",
    "build_lr_scheduler",
    "build_optimizer",
]
