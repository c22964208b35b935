"""CLI entry: serve a trained model over HTTP on the GPU.

Loads outputs/<exp_id>/model_cache/<model>_<dataset>.pt for the same
task/model/dataset/exp_id and exposes:

    POST /predict  {"x": [[...]]}   -> {"prediction": ..., "shape": [...]}
    GET  /health                    -> service stats

Example:
    python -m multistgraph_tpu_torch.serve_model --dataset SYN_DC --exp_id 1 \\
        --compute_dtype bfloat16 --weight_stream_quant int8 --port 8800
    python -m multistgraph_tpu_torch.serve_model --dataset SYN_DC --exp_id 1 --quantize int8
"""

import argparse

from multistgraph_tpu_torch.serving import PredictService, serve
from multistgraph_tpu_torch.utils.arguments import add_general_args, collect_other_args


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", type=str, default="traffic_state_pred")
    parser.add_argument("--model", type=str, default="MultiATGCN")
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--config_file", type=str, default=None)
    parser.add_argument("--exp_id", type=str, required=True,
                        help="experiment whose cached model to serve")
    parser.add_argument("--port", type=int, default=8800)
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--max_serve_batch", type=int, default=64)
    parser.add_argument("--quantize", choices=("int8", "bfloat16"), default=None,
                        help="weight-only quantization: store the parameters int8 (about 4x "
                             "smaller) or bfloat16 (2x), dequantized inside the predict forward")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default CUDA (pass 'cpu' to run without a card)")
    add_general_args(parser)
    args = parser.parse_args(argv)
    other_args = collect_other_args(args, exclude=("port", "host", "max_serve_batch", "device", "quantize"))
    service = PredictService.from_experiment(
        args.task, args.model, args.dataset, args.config_file,
        other_args=other_args, max_batch=args.max_serve_batch, device=args.device,
        quantize=args.quantize)
    serve(service, port=args.port, host=args.host)


if __name__ == "__main__":
    main()
