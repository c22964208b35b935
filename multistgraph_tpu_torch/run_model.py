"""CLI entry: train and evaluate a model on a dataset on the GPU (the
port's twin of the repository's run_model.py, ref: run_model.py:9-29).

Example:
    python -m multistgraph_tpu_torch.run_model --dataset SYN_VERIFY \\
        --config_file config_user --exp_id v1 --seed 0 [--device cpu]
"""

import argparse

from multistgraph_tpu_torch.pipeline import run_model
from multistgraph_tpu_torch.utils.arguments import add_general_args, collect_other_args, str2bool


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", type=str, default="traffic_state_pred")
    parser.add_argument("--model", type=str, nargs="+", default=["MultiATGCN"])
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--config_file", type=str, default=None)
    parser.add_argument("--saved_model", type=str2bool, default=True)
    parser.add_argument("--train", type=str2bool, default=True,
                        help="re-train even if a cached model exists")
    parser.add_argument("--exp_id", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--start_dim", type=int, default=0)
    parser.add_argument("--end_dim", type=int, default=1)
    parser.add_argument("--gpu", type=str2bool, default=None,
                        help="false runs on the CPU, as device 'cpu' does")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default CUDA (pass 'cpu' to run without a card)")
    add_general_args(parser)
    args = parser.parse_args(argv)
    other_args = collect_other_args(args, exclude=("device",))
    results = []
    for model_name in args.model:
        results.append(run_model(task=args.task, model_name=model_name, dataset_name=args.dataset,
                                 config_file=args.config_file, saved_model=args.saved_model,
                                 train=args.train, other_args=dict(other_args), device=args.device))
    return results


if __name__ == "__main__":
    main()
