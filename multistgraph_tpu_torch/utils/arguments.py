"""CLI flags for the port's entry points (counterpart of
multistgraph_tpu/utils/arguments.py, limited to the flags the port reads)."""

import argparse


def str2bool(s):
    if isinstance(s, bool):
        return s
    if str(s).lower() in ("yes", "true", "t", "1"):
        return True
    if str(s).lower() in ("no", "false", "f", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def str2float(s):
    if isinstance(s, float):
        return s
    try:
        return float(s)
    except ValueError:
        raise argparse.ArgumentTypeError("Float value expected.")


GENERAL_ARGUMENTS = {
    "train_rate": str2float,
    "eval_rate": str2float,
    "batch_size": int,
    "output_window": int,
    "input_window": int,
    "adjtype": str,
    "adpadj": str,
    "rnn_units": int,
    "num_layers": int,
    "cheb_order": int,
    "use_3tu": str2bool,
    "gcn_off": str2bool,
    "fnn_off": str2bool,
    "node_specific_off": str2bool,
    "add_static": str2bool,
    "load_dynamic": str2bool,
    "data_dir": str,
    "output_dir": str,
    "embed_dim_adj": int,
    "embed_dim_node": int,
    "compute_dtype": str,
    "weight_stream_quant": str,
    # large-graph (SparseATGCN) configs
    "num_nodes": int,            # synthetic graph size
    "avg_degree": int,
    "len_time": int,
    "graph_split": str,          # none | hub | tail | band
    "graph_band_packed": str2bool,  # band form stored as packed rows (serving)
    "remat": str2bool,           # checkpoint each step of the recurrence
    "adaptive_max_blocks": int,  # cap the adaptive pattern
    "use_early_stop": str2bool,
}


def add_general_args(parser: argparse.ArgumentParser) -> None:
    for name, typ in GENERAL_ARGUMENTS.items():
        parser.add_argument("--{}".format(name), type=typ, default=None)


def collect_other_args(args: argparse.Namespace, exclude=()) -> dict:
    """Non-None general args as a dict, skipping pipeline-reserved names."""
    reserved = set(exclude) | {"task", "model", "dataset", "config_file", "saved_model", "train"}
    return {k: v for k, v in vars(args).items() if k not in reserved and v is not None}
