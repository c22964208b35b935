"""One-shot train + evaluate pipeline (counterpart of
multistgraph_tpu/pipeline.py, ref: libcity/pipeline/pipeline.py:16-62).

config -> dataset -> model -> executor, on `device` (CUDA unless the caller
or the config asks for the CPU: ``gpu: false`` means ``device="cpu"``). The
trained model is saved as outputs/<exp_id>/model_cache/<model>_<dataset>.pt,
which ``PredictService.from_experiment`` serves.
"""

import os
import random
from typing import Any, Dict, Optional

from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.executor import get_executor
from multistgraph_tpu_torch.models import get_model
from multistgraph_tpu_torch.utils import get_logger, resolve_device, set_random_seed


def run_model(task: str = None, model_name: str = None, dataset_name: str = None,
              config_file: str = None, saved_model: bool = True, train: bool = True,
              other_args: Optional[Dict[str, Any]] = None, device=None):
    """Train (or reuse a cached model) and evaluate; returns the test-result
    table ({metric: [value per horizon]})."""
    config = load_config(task, model_name, dataset_name, config_file, saved_model, train, other_args)
    if device is None and not config.get("gpu", True):
        device = "cpu"
    device = resolve_device(device)
    exp_id = config.get("exp_id", None)
    if exp_id is None:
        exp_id = int(random.SystemRandom().random() * 100000)
        config["exp_id"] = exp_id

    logger = get_logger(name="multistgraph_tpu_torch")
    logger.info("Begin pipeline, task=%s, model_name=%s, dataset_name=%s, exp_id=%s, device=%s",
                task, model_name, dataset_name, exp_id, device)
    set_random_seed(config.get("seed", 0))

    dataset = get_dataset(config, device)
    train_data, valid_data, test_data = dataset.get_data()
    data_feature = dataset.get_data_feature()
    model = get_model(config, data_feature, device=device)
    executor = get_executor(config, model, data_feature, device=device)

    model_cache_file = os.path.join(config.get("output_dir", "./outputs"), str(exp_id),
                                    "model_cache", "{}_{}.pt".format(model_name, dataset_name))
    if train or not os.path.exists(model_cache_file):
        executor.train(train_data, valid_data)
        if saved_model:
            executor.save_model(model_cache_file)
    else:
        executor.load_model(model_cache_file)
    return executor.evaluate(test_data)
