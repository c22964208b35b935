"""Train all protocol seeds as one widened step, then evaluate each.

Counterpart of tools/multiseed_run.py: parallel/multiseed.py trains the
seeds together, writing each seed's best checkpoint where the port's
``run_model --train false --exp_id {base}_{seed}`` looks; each seed is then
evaluated through that pipeline, with the usual per-seed artifacts.

Usage:
    python -m multistgraph_tpu_torch.tools.multiseed_run --dataset SYN_DC237 \\
        --seeds 0 10 100 1000 [--model MultiATGCN] [--config_file cfg] \\
        [--exp_id base] [--skip_eval true] [--device cpu]
"""

import argparse

from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.executor import get_executor
from multistgraph_tpu_torch.models import get_model
from multistgraph_tpu_torch.parallel.multiseed import train_multiseed
from multistgraph_tpu_torch.pipeline import run_model
from multistgraph_tpu_torch.utils import resolve_device
from multistgraph_tpu_torch.utils.arguments import add_general_args, collect_other_args, str2bool


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--task", default="traffic_state_pred")
    ap.add_argument("--model", default="MultiATGCN")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--config_file", default=None)
    ap.add_argument("--exp_id", default=None)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 10, 100, 1000])
    ap.add_argument("--skip_eval", type=str2bool, default=False)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default CUDA (pass 'cpu' to run without a card)")
    add_general_args(ap)
    args = ap.parse_args(argv)

    other = collect_other_args(args, exclude=("seeds", "skip_eval", "exp_id", "device"))
    other["exp_id"] = args.exp_id or "{}_{}_multiseed".format(args.model, args.dataset)
    other["seed"] = args.seeds[0]
    config = load_config(args.task, args.model, args.dataset, args.config_file,
                         saved_model=True, train=True, other_args=other)
    device = resolve_device("cpu" if args.device is None and not config.get("gpu", True) else args.device)
    dataset = get_dataset(config, device)
    train_data, valid_data, _ = dataset.get_data()
    feature = dataset.get_data_feature()
    executor = get_executor(config, get_model(config, feature, device=device), feature, device=device)

    results = train_multiseed(executor, train_data, valid_data, args.seeds, save=True)
    print("seed  best_epoch  min_val_loss  stopped  checkpoint")
    for r in results:
        print("{:>4}  {:>10}  {:>12.4f}  {!s:>7}  {}".format(
            r.seed, r.best_epoch, r.min_val_loss, r.stopped_epoch, r.checkpoint))
    if args.skip_eval:
        return results
    for r in results:
        eval_args = dict(other, exp_id="{}_{}".format(config["exp_id"], r.seed), seed=r.seed)
        print("=== evaluating seed {} (exp_id {}) ===".format(r.seed, eval_args["exp_id"]))
        run_model(task=args.task, model_name=args.model, dataset_name=args.dataset,
                  config_file=args.config_file, saved_model=True, train=False,
                  other_args=eval_args, device=device)
    return results


if __name__ == "__main__":
    main()
