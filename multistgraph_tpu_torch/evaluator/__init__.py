from multistgraph_tpu_torch.evaluator.evaluator import (
    EVALUATOR_REGISTRY,
    TrafficStateEvaluator,
    evaluate_model,
    get_evaluator,
)

__all__ = [
    "EVALUATOR_REGISTRY",
    "TrafficStateEvaluator",
    "evaluate_model",
    "get_evaluator",
]
