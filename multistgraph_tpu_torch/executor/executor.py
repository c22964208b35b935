"""Training executor: train step, epoch loop, checkpoints, evaluation.

Counterpart of multistgraph_tpu/executor/executor.py (ref:
libcity/executor/traffic_state_executor.py:17-448): optimizer and scheduler
factories, the config-selected train loss, the epoch loop with train and
validation phases, timing and scalar logging, best-epoch checkpoints, early
stop on patience, best-epoch reload, resume from ``epoch``, and full-test
evaluation with the raw prediction .npz, per-horizon metrics and the
group-based re-transform.

Design, against the JAX executor's compiled programs (the train step, the
epoch scan, the validation and prediction scans; executor.py:159-164):
  * one step is loss -> ``backward`` (the model's hand-written BPTT) ->
    global-norm clip -> ``optimizer.step`` (``train_step``, eager, public);
    a batch is an ``index_select`` of the device-resident split at the
    loader's ``epoch_permutation()`` (the same numpy shuffle stream as JAX);
  * on CUDA, for a model that declares itself ``graph_safe`` (MultiATGCN,
    SparseATGCN),
    ``train_epoch`` runs the train step as a CUDA graph (graphs.py): the
    first ``GRAPH_WARMUP_STEPS`` batches of the executor's life run
    eagerly on a side stream, then the step is captured, reading the
    batch's (B,) sample indices from a static buffer, and each further
    batch is one device-to-device copy of its indices from the epoch's
    permutation (uploaded once an epoch) and one replay. This is the port's
    counterpart of ``_train_epoch_scan``. ``_valid_epoch`` and ``predict``
    replay a captured no-grad forward the same way, after one eager batch.
    Learners whose torch step cannot be captured run eagerly
    (``optimizers.capture_rule``); so does every other model, and every
    model on the CPU;
  * the graphs hold the optimizer's state tensors and the loader's split:
    ``load_model``, ``load_model_with_epoch`` and a change of rate under
    a "re-capture" learner throw them away, and the next epoch captures
    again (the model's ``load_state_dict`` copies in place, an optimizer's
    does not);
  * per-batch losses stay on the device and are read once per epoch;
  * dropout draws from a ``torch.Generator`` that the executor owns,
    seeded from ``config['seed']``, registered with the train graph, so a
    replay draws what the eager step would;
  * scheduled sampling (a model with ``cl_decay_steps > 0``: DCRNN), the
    counterpart of JAX's ``training_apply_kwargs`` and ``_tf_ratio``
    (multi_atgcn.py:1018-1033, executor.py:223-230): a train step hands
    the model the batch's targets (``start_dim:end_dim``) and the
    teacher-forcing ratio cl/(cl + exp(i/cl)) at global step
    i = epoch * batches + batch, computed on the host in f32
    (``teacher_forcing_ratio``) and written before each step into a device
    scalar (``tf_ratio``) that the eager step and the captured one read;
    the model draws its coins from the dropout generator. Validation and
    prediction roll out autoregressively;
  * ``profile_dir`` (and ``profile_epoch``, default 1) writes a
    ``torch.profiler`` trace of that epoch's train and validation phases
    (CPU activity, and CUDA activity on the card) to
    ``<profile_dir>/epoch<N>.pt.trace.json``, as the JAX executor brackets
    the same span with ``jax.profiler``, with ``PROFILE_MARGIN_S`` of
    sleep at either end so that the trace keeps every kernel record;
  * checkpoints are ``torch.save`` files: ``{"model", "optimizer",
    "epoch"}`` per epoch, and the ``(model state_dict, optimizer
    state_dict)`` tuple of the final model, which ``PredictService.from_experiment``
    reads;
  * without pandas, the ``_predictions_trans.pkl`` table is an .npz with
    the same columns, and the CSVs are written with the ``csv`` module.

The loops that replay the graphs are ``StepLoops``, which the multi-seed
trainer (parallel/multiseed.py) shares. ``report_hook`` and ``hyper_tune``
stay as attributes for the tuner.
"""

import contextlib
import datetime
import os
import time
from functools import partial
from typing import Dict

import numpy as np
import torch

from multistgraph_tpu_torch.evaluator.evaluator import get_evaluator, write_csv
from multistgraph_tpu_torch.executor.graphs import StepGraph, on_side_stream
from multistgraph_tpu_torch.executor.optimizers import (
    build_lr_scheduler,
    build_optimizer,
    capture_rule,
    clip_by_global_norm,
    load_optimizer_state,
    set_learning_rate,
)
from multistgraph_tpu_torch.ops import losses
from multistgraph_tpu_torch.ops.losses import make_pred_loss
from multistgraph_tpu_torch.utils import ensure_dir, get_logger, resolve_device

_NAMED_LOSSES = {
    "mae": losses.masked_mae,
    "mse": losses.masked_mse,
    "rmse": losses.masked_rmse,
    "mape": losses.masked_mape,
    "logcosh": losses.log_cosh_loss,
    "huber": losses.huber_loss,
    "quantile": losses.quantile_loss,
    "masked_mae": partial(losses.masked_mae, null_val=0.0),
    "masked_mse": partial(losses.masked_mse, null_val=0.0),
    "masked_rmse": partial(losses.masked_rmse, null_val=0.0),
    "masked_mape": partial(losses.masked_mape, null_val=0.0),
    "r2": losses.r2_score,
    "evar": losses.explained_variance_score,
}

# eager train steps before the train step is captured (PyTorch's
# whole-network recipe warms up on a side stream; these are real steps)
GRAPH_WARMUP_STEPS = 2
# host sleep after the profiler starts and before it stops: the trace keeps
# only the card's records whose times, mapped to the host's clock, fall
# between the two, and on an H100 the epoch's last kernels mapped up to
# ~0.4 ms past the host's last event, so that a trace lost the tail of
# the last validation batch (tools/probe_profile_records.py)
PROFILE_MARGIN_S = 0.02


class StepLoops:
    """The train and forward loops of an executor, eager or as replays of
    CUDA graphs (module docstring). The executor sets ``device``,
    ``graphs_forward``, ``graphs_train``, ``capture_rule``, ``graphs``,
    ``_warm_steps``, ``_side_stream`` and ``generators`` (the dropout
    generators its train step draws from), with a model that has scheduled
    sampling also ``cl_decay_steps`` and ``tf_ratio``, and defines
    ``batch(loader, idx)`` and ``train_step(batch)``; ``before_train_step()``
    refills what a step reads besides its batch."""

    # scheduled sampling (module docstring): the teacher-forcing ratio's
    # decay, the global step, and the device scalar every step reads (None:
    # the model has no scheduled sampling)
    cl_decay_steps = 0
    global_step = 0
    tf_ratio = None

    def before_train_step(self) -> None:
        """Called before each train step, eager or replayed: write the
        teacher-forcing ratio of the coming step into the device scalar the
        step reads (a fill queued on the stream, no sync), and count the
        step."""
        if self.tf_ratio is not None:
            self.tf_ratio.fill_(float(teacher_forcing_ratio(self.cl_decay_steps, self.global_step)))
        self.global_step += 1

    def train_steps(self, loader, perm, rate) -> torch.Tensor:
        """One train step per row of `perm` (the sample indices of one step
        each), the losses stacked on the device. `rate` keys the captured
        step where the learner bakes its rate into it."""
        if not self.graphs_train:
            losses = []
            for idx in perm:
                self.before_train_step()
                losses.append(self.train_step(self.batch(loader, idx)))
            return torch.stack(losses)
        perm = torch.as_tensor(perm, device=self.device)  # the epoch's one upload
        out = None
        for i in range(len(perm)):
            self.before_train_step()
            graph = self._train_graph(loader, rate, perm.shape[1:])
            if graph is None:
                loss = on_side_stream(lambda: self.train_step(self.batch(loader, perm[i])), self._side_stream)
                self._warm_steps += 1
            else:
                loss = graph.run(idx=perm[i])
            if out is None:
                out = torch.empty((len(perm),) + loss.shape, dtype=loss.dtype, device=self.device)
            out[i].copy_(loss)
        return out

    def _train_graph(self, loader, rate, idx_shape):
        """The captured train step over `loader`'s split (captured here the
        first time it is asked for after the warm-up), or None while the
        executor is warming up."""
        if self._warm_steps < GRAPH_WARMUP_STEPS:
            return None
        key = (loader.x, loader.y, rate if self.capture_rule == "re-capture" else None)
        graph = self.graphs.get("train")
        if graph is None or not _same_key(graph.key, key):
            self.graphs.pop("train", None)
            graph = self._capture(lambda idx: self.train_step(self.batch(loader, idx)),
                                  idx_shape, self.generators)
            graph.key = key
            self.graphs["train"] = graph
        return graph

    def _capture(self, step, idx_shape, generators=()) -> StepGraph:
        """``step(idx)`` captured with its sample indices in a static buffer."""
        idx = torch.zeros(idx_shape, dtype=torch.int64, device=self.device)
        return StepGraph(lambda: step(idx), inputs={"idx": idx}, generators=generators)

    def _forward_epoch(self, name: str, loader, step):
        """``step(idx)`` (no autograd) over the loader's batches in order,
        stacked: eager on CPU tensors and for models that are not
        graph_safe; else its first batch eager on a side stream the first
        time (the warm-up), and replays of graph `name`."""
        perm = loader.ordered_permutation()
        if not self.graphs_forward:
            return torch.stack([step(torch.as_tensor(idx, device=loader.x.device)) for idx in perm])
        perm = torch.as_tensor(perm, device=self.device)
        key = (loader.x, loader.y)
        graph = self.graphs.get(name)
        out = None
        for i in range(len(perm)):
            if graph is None or not _same_key(graph.key, key):
                value = on_side_stream(lambda: step(perm[i]), self._side_stream)
                self.graphs.pop(name, None)
                graph = self._capture(step, (loader.batch_size,))
                graph.key = key
                self.graphs[name] = graph
            else:
                value = graph.run(idx=perm[i])
            if out is None:
                out = torch.empty((len(perm),) + value.shape, dtype=value.dtype, device=self.device)
            out[i].copy_(value)
        return out

    def drop_graphs(self) -> None:
        """Throw the captured steps away (after anything that replaces a
        tensor they read); the next epoch captures again."""
        self.graphs.clear()


class TrafficStateExecutor(StepLoops):
    """Trains and evaluates `model` on `device` (CUDA unless "cpu" is asked
    for; the model is moved there)."""

    def __init__(self, config, model, data_feature, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.data_feature = data_feature
        self.evaluator = get_evaluator(config)
        self._scaler = data_feature.get("scaler")
        self.exp_id = config.get("exp_id", None)
        self.output_window = config.get("output_window", 1)
        self.start_dim = config.get("start_dim", 0)
        self.end_dim = config.get("end_dim", 1)
        self.groupstd = config.get("groupstd", False)
        self.ct_visit_mstd = data_feature.get("ct_visit_mstd")
        self.output_dim = config.get("output_dim", 1)

        output_root = config.get("output_dir", "./outputs")
        self.cache_dir = os.path.join(output_root, str(self.exp_id), "model_cache")
        self.evaluate_res_dir = os.path.join(output_root, str(self.exp_id), "evaluate_cache")
        self.summary_dir = os.path.join(output_root, str(self.exp_id))
        for d in (self.cache_dir, self.evaluate_res_dir, self.summary_dir):
            ensure_dir(d)
        self._logger = get_logger(name="multistgraph_tpu_torch.executor")
        self._metrics_log = os.path.join(self.summary_dir, "train_metrics.csv")
        self._writer = None
        if config.get("tensorboard", True):
            from multistgraph_tpu_torch.utils.tbwriter import SummaryWriter

            self._writer = SummaryWriter(self.summary_dir)

        self.epochs = config.get("max_epoch", 100)
        self.train_loss_name = str(config.get("train_loss", "none")).lower()
        self.use_early_stop = config.get("use_early_stop", False)
        self.patience = config.get("patience", 50)
        self.log_every = config.get("log_every", 1)
        self.saved = config.get("saved_model", True)
        self.load_best_epoch = config.get("load_best_epoch", True)
        self.hyper_tune = config.get("hyper_tune", False)
        self.report_hook = None  # set by the hyperparameter tuner
        self.clip_grad_norm = config.get("clip_grad_norm", False)
        self.max_grad_norm = config.get("max_grad_norm", 1.0)

        self.dropout_generator = torch.Generator(device=self.device).manual_seed(int(config.get("seed", 0)))
        self.generators = (self.dropout_generator,)
        # scheduled sampling (module docstring): the global step and the
        # device scalar of its teacher-forcing ratio, which every step reads
        self.cl_decay_steps = int(getattr(model, "cl_decay_steps", 0) or 0)
        self.global_step = 0
        self.tf_ratio = None
        if self.cl_decay_steps > 0:
            self.tf_ratio = torch.tensor(float(teacher_forcing_ratio(self.cl_decay_steps, 0)), device=self.device)
        num_params = 0
        for name, p in model.named_parameters():
            self._logger.info("%s\t%s", name, tuple(p.shape))
            num_params += p.numel()
        self._logger.info("Total parameter numbers: %d", num_params)

        self.optimizer = build_optimizer(config, model.parameters(), device=self.device)
        self.lr_scheduler = build_lr_scheduler(config)
        self.pred_loss = self._build_train_loss()

        # CUDA graphs (module docstring): which steps replay, and their state
        self.capture_rule = capture_rule(config.get("learner", "adam"))
        self.graphs_forward = self.device.type == "cuda" and getattr(model, "graph_safe", False)
        self.graphs_train = self.graphs_forward and self.capture_rule != "eager"
        self.graphs: Dict[str, StepGraph] = {}  # "train", "valid", "predict"
        self._warm_steps = 0
        self._side_stream = torch.cuda.Stream(self.device) if self.graphs_forward else None

        self._epoch_num = config.get("epoch", 0)
        if self._epoch_num > 0:
            self.load_model_with_epoch(self._epoch_num)

    # ------------------------------------------------------------------ loss
    def _build_train_loss(self):
        """Config-selected train loss, else the model's own (ref :200-250),
        as ``pred_loss(pred, y)``: the loss of a prediction against its
        batch's targets."""
        if self.train_loss_name == "none":
            self._logger.warning("Received none train loss func and will use the loss func defined in the model.")
            return make_pred_loss(self.model, self._scaler)
        if self.train_loss_name not in _NAMED_LOSSES:
            self._logger.warning("Received unrecognized train loss function, set default mae loss func.")
            lf = losses.masked_mae
        else:
            lf = _NAMED_LOSSES[self.train_loss_name]
        out_dim = self.output_dim

        def pred_loss(pred, y):
            y_true = self._scaler.inverse_transform(y[..., :out_dim])
            y_pred = self._scaler.inverse_transform(pred[..., :out_dim])
            return lf(y_pred, y_true)

        return pred_loss

    def loss_fn(self, batch, train: bool = True, generator=None) -> torch.Tensor:
        """The train loss of the model on `batch` (``train`` turns dropout on,
        and with a generator scheduled sampling, where the model has it)."""
        extra = {}
        if train and generator is not None and self.tf_ratio is not None:
            extra = {"targets": batch["y"][..., self.model.start_dim: self.model.end_dim],
                     "tf_ratio": self.tf_ratio}
        return self.pred_loss(self.model(batch["X"], train=train, generator=generator, **extra), batch["y"])

    # ------------------------------------------------------------- train step
    def train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step on `batch` at the optimizer's current rate;
        returns the loss as a 0-d device tensor (no host sync)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(batch, train=True, generator=self.dropout_generator)
        loss.backward()
        if self.clip_grad_norm:
            clip_by_global_norm(self.model.parameters(), self.max_grad_norm)
        self.optimizer.step()
        return loss.detach()

    def batch(self, loader, idx) -> Dict[str, torch.Tensor]:
        """The samples `idx` (numpy or a device tensor) of a device loader's
        split, as a batch dict."""
        idx = torch.as_tensor(idx, device=loader.x.device)
        return {"X": loader.x.index_select(0, idx), "y": loader.y.index_select(0, idx)}

    def train_epoch(self, train_loader, lr: float) -> float:
        """One epoch over a fresh ``epoch_permutation()`` at rate `lr`; the
        mean batch loss, read from the device once. On CUDA a graph_safe
        model's steps are replays of the captured train step."""
        set_learning_rate(self.optimizer, lr)
        return float(self.train_steps(train_loader, train_loader.epoch_permutation(), lr).mean())

    @contextlib.contextmanager
    def _profiled(self, epoch_idx: int):
        """A ``torch.profiler`` trace of the block when `epoch_idx` is
        ``profile_epoch`` (default 1) and ``profile_dir`` is set, written to
        ``<profile_dir>/epoch<N>.pt.trace.json`` (JAX executor.py:303-347)."""
        profile_dir = self.config.get("profile_dir", None)
        if profile_dir is None or epoch_idx != self.config.get("profile_epoch", 1):
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            time.sleep(PROFILE_MARGIN_S)
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            time.sleep(PROFILE_MARGIN_S)
        ensure_dir(profile_dir)
        path = os.path.join(profile_dir, "epoch{}.pt.trace.json".format(epoch_idx))
        prof.export_chrome_trace(path)
        self._logger.info("profiler trace for epoch %d written to %s", epoch_idx, path)

    # --------------------------------------------------------------- training
    def train(self, train_dataloader, eval_dataloader) -> float:
        self._logger.info("Start training ...")
        min_val_loss = float("inf")
        wait = 0
        best_epoch = 0
        train_time, eval_time = [], []
        self._logger.info("num_batches:%d", len(train_dataloader))

        if not os.path.exists(self._metrics_log) or os.path.getsize(self._metrics_log) == 0:
            with open(self._metrics_log, "a") as f:
                f.write("epoch,train_loss,val_loss,lr,seconds\n")

        for epoch_idx in range(self._epoch_num, self.epochs):
            self.global_step = epoch_idx * len(train_dataloader)
            with self._profiled(epoch_idx):
                start_time = time.time()
                lr = (self.lr_scheduler.lr_for_epoch(epoch_idx) if self.lr_scheduler is not None
                      else self.config.get("learning_rate", 0.01))
                train_loss = self.train_epoch(train_dataloader, lr)
                t1 = time.time()
                train_time.append(t1 - start_time)

                val_loss = self._valid_epoch(eval_dataloader)
                end_time = time.time()
                eval_time.append(end_time - t1)

            if self.lr_scheduler is not None:
                self.lr_scheduler.step_plateau(val_loss)

            if (epoch_idx % self.log_every) == 0:
                self._logger.info("Epoch [%d/%d] train_loss: %.4f, val_loss: %.4f, lr: %.6f, %.2fs",
                                  epoch_idx, self.epochs, train_loss, val_loss, lr, end_time - start_time)
            with open(self._metrics_log, "a") as f:
                f.write("{},{:.6f},{:.6f},{:.6g},{:.2f}\n".format(
                    epoch_idx, train_loss, val_loss, lr, end_time - start_time))
            if self._writer is not None:
                # the reference's tags (ref :347,447) and the lr schedule
                self._writer.add_scalar("training loss", train_loss, epoch_idx)
                self._writer.add_scalar("eval loss", val_loss, epoch_idx)
                self._writer.add_scalar("learning rate", lr, epoch_idx)

            if self.hyper_tune and self.report_hook is not None:
                if self.report_hook(epoch_idx, val_loss, self):
                    self._logger.warning("Trial stopped by scheduler at epoch: %d", epoch_idx)
                    break

            if val_loss < min_val_loss:
                wait = 0
                if self.saved:
                    model_file_name = self.save_model_with_epoch(epoch_idx)
                    self._logger.info("Val loss decrease from %.4f to %.4f, saving to %s",
                                      min_val_loss, val_loss, model_file_name)
                min_val_loss = val_loss
                best_epoch = epoch_idx
            else:
                wait += 1
                if wait == self.patience and self.use_early_stop:
                    self._logger.warning("Early stopping at epoch: %d", epoch_idx)
                    break

        if train_time:
            self._logger.info(
                "Trained totally %d epochs, average train time is %.3fs, average eval time is %.3fs",
                len(train_time), sum(train_time) / len(train_time), sum(eval_time) / len(eval_time))
        if self.load_best_epoch and self.saved:
            self.load_model_with_epoch(best_epoch)
        return min_val_loss

    @torch.no_grad()
    def _valid_epoch(self, eval_dataloader) -> float:
        vals = self._forward_epoch("valid", eval_dataloader,
                                   lambda idx: self.loss_fn(self.batch(eval_dataloader, idx), train=False))
        return float(vals.mean())

    # ------------------------------------------------------------- evaluation
    @torch.no_grad()
    def predict(self, loader) -> np.ndarray:
        """Model-space predictions (S, Tout, N, D) over the loader in order."""
        outs = self._forward_epoch("predict", loader, lambda idx: self.model(self.batch(loader, idx)["X"]))
        return outs.flatten(0, 1).float().cpu().numpy()

    def evaluate(self, test_dataloader):
        """Full-test evaluation and artifacts (ref :252-323); the target
        channels are the model's own start_dim/end_dim."""
        self._logger.info("Start evaluating ...")
        s_dim = getattr(self.model, "start_dim", self.start_dim)
        e_dim = getattr(self.model, "end_dim", self.end_dim)
        output = self.predict(test_dataloader)
        order = test_dataloader.ordered_permutation().reshape(-1)
        y_all = test_dataloader.y.cpu().numpy()[order]
        y_truths = np.asarray(self._scaler.inverse_transform(y_all[:, : self.output_window, :, s_dim:e_dim]))
        y_preds = np.asarray(self._scaler.inverse_transform(output[..., : e_dim - s_dim]))

        stamp = time.strftime("%Y_%m_%d_%H_%M_%S", time.localtime(time.time()))
        tag = "{}_{}_{}".format(stamp, self.config.get("model"), self.config.get("dataset"))
        np.savez_compressed(os.path.join(self.evaluate_res_dir, tag + "_predictions.npz"),
                            prediction=y_preds, truth=y_truths)
        self.evaluator.clear()
        self.evaluator.collect({"y_true": y_truths, "y_pred": y_preds})
        test_result = self.evaluator.save_result(self.evaluate_res_dir)

        if self.groupstd and self.ct_visit_mstd is not None:
            self._group_retransform_eval(y_preds, y_truths, tag)
        return test_result

    def _group_retransform_eval(self, y_preds, y_truths, tag):
        """Group-based de-z-score metrics, the paper's headline protocol
        (ref :292-322; JAX executor.py:454-508). Writes <tag>_predictions_trans.npz
        (the columns of the JAX package's _predictions_trans.pkl table) and
        <tag>_trans.csv; returns the per-horizon rows as a column dict."""
        sh = y_preds.shape  # (S, Tout, N, D)
        mstd = self.ct_visit_mstd
        all_m = np.asarray(mstd["All_m"])[None, None, :, None]
        all_s = np.asarray(mstd["All_std"])[None, None, :, None]
        pred_t = y_preds * all_s + all_m
        truth_t = y_truths * all_s + all_m
        np.savez_compressed(
            os.path.join(self.evaluate_res_dir, tag + "_predictions_trans.npz"),
            prediction=y_preds.ravel(), truth=y_truths.ravel(),
            All_m=np.broadcast_to(all_m, sh).ravel(), All_std=np.broadcast_to(all_s, sh).ravel(),
            geo_id=np.broadcast_to(np.asarray(mstd["geo_id"])[None, None, :, None], sh).ravel(),
            ahead_step=np.broadcast_to(np.arange(sh[1])[None, :, None, None], sh).ravel(),
            prediction_t=pred_t.ravel(), truth_t=truth_t.ravel())

        pred_t = np.maximum(pred_t, 0.0)
        s_small = 10.0
        columns = ["Model_name", "index", "Model_time", "MAE", "MSE", "RMSE", "R2", "EVAR", "MAPE"]
        rows = []
        for rr in range(sh[1]):
            keep = truth_t[:, rr] > s_small
            pr = pred_t[:, rr][keep]
            tr = truth_t[:, rr][keep]
            diff = pr - tr
            mae = float(np.abs(diff).mean())
            mse = float((diff ** 2).mean())
            rmse = float(np.sqrt(mse))
            # the reference passes (pred, truth) to sklearn's r2_score and
            # explained_variance_score, whose signature is (y_true, y_pred):
            # arguments swapped, reproduced as they are
            r2 = float(1.0 - (diff ** 2).sum() / ((pr - pr.mean()) ** 2).sum())
            evar = float(1.0 - np.var(tr - pr) / np.var(pr))
            mape = float(np.abs(diff / tr).mean())
            rows.append([self.config.get("model"), rr, datetime.datetime.now(), mae, mse, rmse, r2, evar, mape])
        write_csv(os.path.join(self.evaluate_res_dir, tag + "_trans.csv"), [""] + columns,
                  [[i] + row for i, row in enumerate(rows)])
        return {c: [row[j] for row in rows] for j, c in enumerate(columns)}

    # ------------------------------------------------------------ checkpoints
    def _checkpoint_blob(self, epoch: int = 0) -> Dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "epoch": int(epoch)}

    def save_model(self, cache_name: str):
        """The final model as the (model state_dict, optimizer state_dict)
        tuple the reference writes (and PredictService.from_experiment reads)."""
        ensure_dir(os.path.dirname(cache_name))
        self._logger.info("Saved model at %s", cache_name)
        torch.save((self.model.state_dict(), self.optimizer.state_dict()), cache_name)

    def load_model(self, cache_name: str):
        self._logger.info("Loaded model at %s", cache_name)
        model_state, optimizer_state = torch.load(cache_name, map_location=self.device, weights_only=True)
        self.model.load_state_dict(model_state)
        load_optimizer_state(self.optimizer, optimizer_state)
        self.drop_graphs()

    def _epoch_path(self, epoch: int) -> str:
        return os.path.join(self.cache_dir, "{}_{}_epoch{}.pt".format(
            self.config.get("model"), self.config.get("dataset"), epoch))

    def save_model_with_epoch(self, epoch: int) -> str:
        path = self._epoch_path(epoch)
        ensure_dir(self.cache_dir)
        torch.save(self._checkpoint_blob(epoch), path)
        self._logger.info("Saved model at %d", epoch)
        return path

    def load_model_with_epoch(self, epoch: int):
        path = self._epoch_path(epoch)
        if not os.path.exists(path):
            raise FileNotFoundError("Weights at epoch {} not found".format(epoch))
        blob = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(blob["model"])
        load_optimizer_state(self.optimizer, blob["optimizer"])
        self.drop_graphs()
        self._logger.info("Loaded model at %d", epoch)


def teacher_forcing_ratio(cl_decay_steps, steps):
    """Scheduled sampling's teacher-forcing ratio cl/(cl + exp(i/cl)) at
    global step(s) i (the DCRNN paper's eq. 9), in f32 as the JAX executor
    computes it; numpy's exp and XLA's may differ in the last bit."""
    cl = np.float32(cl_decay_steps)
    return cl / (cl + np.exp(np.asarray(steps, np.float32) / cl))


def _same_key(a, b) -> bool:
    """Whether two graph keys (tensors, compared by identity, and rates) match."""
    return len(a) == len(b) and all(x is y if isinstance(x, torch.Tensor) else x == y for x, y in zip(a, b))


EXECUTOR_REGISTRY = {"TrafficStateExecutor": TrafficStateExecutor}


def get_executor(config, model, data_feature, device=None):
    """Executor by config['executor'] on `device` (CUDA unless "cpu" is asked for)."""
    name = config.get("executor", "TrafficStateExecutor")
    if name not in EXECUTOR_REGISTRY:
        raise AttributeError("executor {} is not registered".format(name))
    return EXECUTOR_REGISTRY[name](config, model, data_feature, device=device)
