"""Default configuration values for the port's slice, layered like the JAX package.

A copy of the part of multistgraph_tpu/config/defaults.py that the port's
paths read: ``traffic_state_pred/MultiATGCN`` -> ``MTHDataset``,
``traffic_state_pred/SparseATGCN`` -> ``SyntheticLargeGraphDataset`` and
the model zoo's 18 names (RNN with its LSTM and GRU aliases, FNN, Seq2Seq,
AGCRN, TGCN, STGCN, GWNET, DCRNN, ASTGCN, MSTGCN, MTGNN, STSGCN, STTN,
GMAN, STGODE, STGNCDE) -> ``TrafficStatePointDataset``, with their task
bindings, model and data defaults, and the executor and evaluator
defaults, which also merge into a run's config.
Values reproduce the reference defaults
(ref: libcity/config/model/traffic_state_pred/MultiATGCN.json:1-31,
 libcity/config/data/MTHDataset.json:1-21,
 libcity/config/executor/TrafficStateExecutor.json:1-33,
 libcity/config/evaluator/TrafficStateEvaluator.json:1-5).
"""

# the model zoo's families, as the task registry names them
ZOO_MODELS = ("RNN", "LSTM", "GRU", "FNN", "Seq2Seq", "AGCRN", "TGCN", "STGCN", "GWNET", "DCRNN",
              "ASTGCN", "MSTGCN", "MTGNN", "STSGCN", "STTN", "GMAN", "STGODE", "STGNCDE")

TASK_CONFIG = {
    "traffic_state_pred": {
        "allowed_model": ["MultiATGCN", "SparseATGCN"] + list(ZOO_MODELS),
        "models": {
            "MultiATGCN": {
                "dataset_class": "MTHDataset",
                "executor": "TrafficStateExecutor",
                "evaluator": "TrafficStateEvaluator",
            },
            "SparseATGCN": {
                "dataset_class": "SyntheticLargeGraphDataset",
                "executor": "TrafficStateExecutor",
                "evaluator": "TrafficStateEvaluator",
            },
            # the comparison set (LSTM and GRU alias RNN through
            # rnn_type, config/parser.py)
            **{name: {
                "dataset_class": "TrafficStatePointDataset",
                "executor": "TrafficStateExecutor",
                "evaluator": "TrafficStateEvaluator",
            } for name in ZOO_MODELS},
        },
    },
}

MODEL_DEFAULTS = {
    "traffic_state_pred/SparseATGCN": {
        "rnn_units": 64,
        "num_layers": 2,
        "embed_dim_adj": 16,
        "embed_dim_node": 8,
        "adpadj": "unidirection",
        "node_conditioned": "off",
        "remat": True,
        "batch_size": 2,
        "scaler": "standard",
        "learner": "adam",
        "learning_rate": 0.003,
        "clip_grad_norm": True,
        "max_grad_norm": 5,
        "groupstd": False,
    },
    "traffic_state_pred/MultiATGCN": {
        "embed_dim_node": 20,
        "embed_dim_adj": 20,
        "rnn_units": 64,
        "num_layers": 2,
        "cheb_order": 2,
        "use_3tu": True,
        "node_specific_off": False,
        "gcn_off": False,
        "fnn_off": False,
        "bidir_adj_mx": False,
        "batch_size": 16,
        "adpadj": "none",
        "adjtype": "cosine",
        "scaler": "standard",
        "add_static": False,
        "ext_scaler": "none",
        "learner": "adam",
        "learning_rate": 0.003,
        "lr_decay": True,
        "lr_scheduler": "multisteplr",
        "lr_decay_ratio": 0.75,
        "steps": [5, 10, 20, 30],
        "clip_grad_norm": True,
        "max_grad_norm": 5,
    },
}

_ZOO_COMMON = {
    "use_3tu": False, "batch_size": 16, "scaler": "standard",
    "ext_scaler": "none", "learner": "adam", "learning_rate": 0.003,
    "clip_grad_norm": True, "max_grad_norm": 5,
}

# the zoo's defaults, value for value those of the JAX package
MODEL_DEFAULTS.update({
    "traffic_state_pred/RNN": {"rnn_units": 64, "num_layers": 1, "rnn_type": "GRU", **_ZOO_COMMON},
    "traffic_state_pred/FNN": {"rnn_units": 64, "num_layers": 2, **_ZOO_COMMON},
    "traffic_state_pred/Seq2Seq": {"rnn_units": 64, **_ZOO_COMMON},
    "traffic_state_pred/AGCRN": {"rnn_units": 64, "num_layers": 2, "embed_dim_node": 10, "cheb_order": 2,
                                 **_ZOO_COMMON},
    "traffic_state_pred/TGCN": {"rnn_units": 64, **_ZOO_COMMON},
    "traffic_state_pred/STGCN": {"Ks": 3, "Kt": 3, "dropout": 0.0, **_ZOO_COMMON},
    "traffic_state_pred/DCRNN": {"rnn_units": 64, "num_rnn_layers": 2, "max_diffusion_step": 2,
                                 "filter_type": "dual_random_walk", "cl_decay_steps": 2000, **_ZOO_COMMON},
    "traffic_state_pred/ASTGCN": {"nb_block": 2, "nb_filter": 64, "cheb_order": 3, **_ZOO_COMMON},
    "traffic_state_pred/MSTGCN": {"nb_block": 2, "nb_filter": 64, "cheb_order": 3, **_ZOO_COMMON},
    "traffic_state_pred/GWNET": {"residual_channels": 32, "dilation_channels": 32, "skip_channels": 256,
                                 "end_channels": 512, "blocks": 4, "layers": 2, "diffusion_order": 2,
                                 "adpadj": "adaptive", "embed_dim_adj": 10, "dropout": 0.3, **_ZOO_COMMON},
    "traffic_state_pred/STSGCN": {"rnn_units": 64, "gcn_depth": 3, "num_layers": 2, "stsg_window": 3,
                                  "module_type": "individual", **_ZOO_COMMON},
    "traffic_state_pred/STTN": {"rnn_units": 64, "num_heads": 4, "num_blocks": 2, "ffn_dim": 128, "dropout": 0.0,
                                **_ZOO_COMMON},
    "traffic_state_pred/GMAN": {"num_heads": 4, "head_dim": 8, "num_blocks": 1, "se_dim": 16, **_ZOO_COMMON},
    "traffic_state_pred/STGODE": {"rnn_units": 64, "kt": 3, "stgode_blocks": 3, "ode_steps": 6,
                                  "stgode_head_dim": 128, "stgode_dtw_band": 4, "stgode_sparsity": 0.1,
                                  **_ZOO_COMMON},
    "traffic_state_pred/STGNCDE": {"rnn_units": 64, "ncde_field_dim": 64, "embed_dim_node": 10, "cheb_order": 2,
                                   "ncde_substeps": 1, **_ZOO_COMMON},
    "traffic_state_pred/MTGNN": {"embed_dim_node": 40, "subgraph_size": 20, "conv_channels": 32,
                                 "residual_channels": 32, "skip_channels": 64, "end_channels": 128, "layers": 3,
                                 "dilation_exponential": 1, "gcn_depth": 2, "tanhalpha": 3.0, "propalpha": 0.05,
                                 "dropout": 0.3, **_ZOO_COMMON},
})

DATA_DEFAULTS = {
    "SyntheticLargeGraphDataset": {
        "num_nodes": 4096,
        "avg_degree": 16,
        # hybrid graph representation: None | 'hub' | 'tail' | 'band'; the
        # band stored as packed rows with graph_band_packed (serving)
        "graph_split": None,
        "graph_band_packed": False,
        "len_time": 240,
        "batch_size": 2,
        "pad_with_last_sample": True,
        "train_rate": 0.7,
        "eval_rate": 0.15,
        "scaler": "standard",
        "input_window": 12,
        "output_window": 3,
    },
    "MTHDataset": {
        "batch_size": 64,
        "cache_dataset": True,
        "num_workers": 0,
        "pad_with_last_sample": True,
        "train_rate": 0.7,
        "eval_rate": 0.1,
        "scaler": "standard",
        "load_external": False,
        "normal_external": False,
        "ext_scaler": "none",
        "input_window": 12,
        "output_window": 12,
        "add_time_in_day": False,
        "add_day_in_week": False,
        "len_closeness": 1,
        "len_period": 1,
        "len_trend": 2,
        "interval_period": 1,
        "interval_trend": 7,
    },
    # plain sliding windows (use_3tu=False), the zoo's dataset
    "TrafficStatePointDataset": {
        "batch_size": 64,
        "cache_dataset": True,
        "num_workers": 0,
        "pad_with_last_sample": True,
        "train_rate": 0.7,
        "eval_rate": 0.1,
        "scaler": "standard",
        "load_external": False,
        "normal_external": False,
        "ext_scaler": "none",
        "input_window": 12,
        "output_window": 12,
        "add_time_in_day": False,
        "add_day_in_week": False,
    },
}

EXECUTOR_DEFAULTS = {
    "TrafficStateExecutor": {
        "gpu": True,
        "gpu_id": 0,
        "max_epoch": 100,
        "train_loss": "none",
        "epoch": 0,
        "learner": "adam",
        "learning_rate": 0.01,
        "weight_decay": 0,
        "lr_epsilon": 1e-8,
        "lr_beta1": 0.9,
        "lr_beta2": 0.999,
        "lr_alpha": 0.99,
        "lr_momentum": 0,
        "lr_decay": False,
        "lr_scheduler": "multisteplr",
        "lr_decay_ratio": 0.1,
        "steps": [5, 20, 40, 70],
        "step_size": 10,
        "lr_T_max": 30,
        "lr_eta_min": 0,
        "lr_patience": 10,
        "lr_threshold": 1e-4,
        "clip_grad_norm": False,
        "max_grad_norm": 1.0,
        "use_early_stop": False,
        "patience": 50,
        "log_level": "INFO",
        "log_every": 1,
        "saved_model": True,
        "load_best_epoch": True,
        "hyper_tune": False,
    },
}

EVALUATOR_DEFAULTS = {
    "TrafficStateEvaluator": {
        "metrics": [
            "MAE", "MAPE", "MSE", "RMSE",
            "masked_MAE", "masked_MAPE", "masked_MSE", "masked_RMSE",
            "R2", "EVAR",
        ],
        "evaluator_mode": "single",
        "save_mode": ["csv"],
    },
}
