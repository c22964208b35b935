from multistgraph_tpu_torch.data.dataset import (
    DATASET_REGISTRY,
    MTHDataset,
    TrafficStateDataset,
    get_dataset,
)
from multistgraph_tpu_torch.data.loader import DeviceDataLoader, generate_dataloaders

__all__ = [
    "DATASET_REGISTRY",
    "MTHDataset",
    "TrafficStateDataset",
    "get_dataset",
    "DeviceDataLoader",
    "generate_dataloaders",
]
