"""Grid ablation sweep: parameter values x seeds x datasets (the port's twin
of the repository's run_model_parameter.py, ref: run_model_parameter.py:17-59).

Runs the port's pipeline once per combination, like the reference's
nested-loop ablation sweep, and writes the parameter curve
``<output_dir>/sweep_<model>_<parameter>.csv`` (dataset, value, seed, MAE).
Example:

    python -m multistgraph_tpu_torch.run_model_parameter --dataset SYN --parameter adjtype \\
        --values multi od cosine --seeds 0 10 100 1000 [--device cpu]
"""

import argparse
import csv
import json
import os

from multistgraph_tpu_torch.pipeline import run_model
from multistgraph_tpu_torch.utils.arguments import add_general_args, collect_other_args, str2bool


def parse_value(raw: str):
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        return raw


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", type=str, default="traffic_state_pred")
    parser.add_argument("--model", type=str, default="MultiATGCN")
    parser.add_argument("--dataset", type=str, nargs="+", required=True)
    parser.add_argument("--config_file", type=str, default=None)
    parser.add_argument("--saved_model", type=str2bool, default=True)
    parser.add_argument("--parameter", type=str, required=True,
                        help="config key to sweep (e.g. adjtype, rnn_units)")
    parser.add_argument("--values", type=str, nargs="+", required=True,
                        help="values to sweep (JSON-parsed: 64, 0.001, true, multi)")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 10, 100, 1000])
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default CUDA (pass 'cpu' to run without a card)")
    add_general_args(parser)
    args = parser.parse_args(argv)

    base_args = collect_other_args(args, exclude=("parameter", "values", "seeds", "device"))
    rows = []
    for dataset in args.dataset:
        for value in args.values:
            for seed in args.seeds:
                other_args = dict(base_args, seed=seed,
                                  exp_id="{}_{}_{}_{}".format(args.model, args.parameter, value, seed))
                other_args[args.parameter] = parse_value(value)
                print("=== sweep {}={} seed={} dataset={} ===".format(args.parameter, value, seed, dataset))
                result = run_model(task=args.task, model_name=args.model, dataset_name=dataset,
                                   config_file=args.config_file, saved_model=args.saved_model, train=True,
                                   other_args=other_args, device=args.device)
                if result is not None and "masked_MAE" in result:
                    rows.append({"dataset": dataset, "value": parse_value(value), "seed": seed,
                                 "MAE": float(sum(result["masked_MAE"]) / len(result["masked_MAE"]))})
    out = None
    if rows:
        out = os.path.join(base_args.get("output_dir", "./outputs"),
                           "sweep_{}_{}.csv".format(args.model, args.parameter))
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["dataset", "value", "seed", "MAE"])
            writer.writeheader()
            writer.writerows(rows)
        print("sweep summary written to", out)
    return rows, out


if __name__ == "__main__":
    main()
