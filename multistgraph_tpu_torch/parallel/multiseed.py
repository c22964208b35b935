"""Multi-seed training: S seeds of one model in one train step.

Counterpart of multistgraph_tpu/parallel/multiseed.py, which ``jax.vmap``s
the executor's epoch program over a leading seed axis, for every model
without a graph collection. The port chooses the form of the step per
family, statically, by the model class's ``seed_form``:

  * "widened" (MultiATGCN): the model itself runs with that axis
    (``MultiATGCN.forward_seeds``): every parameter is stacked (S, *shape)
    in each forward, each seed's supports, node-conditioned weights and
    residual kernels stay its own, and the node-conditioned applies take
    the seeds' nodes as S*N nodes of one launch, so a step of S seeds
    launches each hand-written kernel as often as one seed's step
    (kernels B2/B2t: 2 a step and layer each way; B3: 4 + 4 a step). Its
    seeds hold against single-seed steps within the card-vs-CPU bounds:
    the batched contractions may sum in another order;
  * "members" (the zoo's 18 names, ``models/zoo.ZooModule``): the S
    members run their own forwards one after the other inside the one
    step (``SeedMembers``), each with its own generator, its loss, its
    backward from the summed losses, its clip and its Adam group: each
    seed computes exactly what its single-seed step computes, bit for bit,
    at S times one seed's launches (none of them a kernel of the port: the
    zoo's families run torch ops). ``torch.func.vmap`` of stacked
    parameters was not taken: its ``randomness="different"`` draws dropout
    and DCRNN's coins from the default generator, not from each seed's,
    and STGNCDE's checkpointed steps and the host-built buffers of GMAN
    and STGODE would need forms of their own. Each member builds its own
    graph constants from the data and the config, so the seeds' buffers
    hold the same values (GMAN's node2vec embedding too: it is drawn from
    ``config['seed']``, the first seed, as JAX's one module draws it);
  * none (SparseATGCN, whose graph lives in buffers the seeds would share,
    as JAX's graph collection): refused, as JAX refuses it.

Per seed, as in JAX:

  * initial weights: the port's single-seed draw at ``seed=s``
    (``get_model(..., generator=torch.Generator().manual_seed(s))``), or
    the state dicts passed in;
  * shuffles: ``np.random.default_rng(s)`` per seed;
  * dropout and DCRNN's coins: a ``torch.Generator`` per seed, seeded with
    s as the single-seed executor seeds its own, registered with the graph;
  * DCRNN's teacher-forcing ratio: one value for all seeds (JAX passes
    the step index unbatched), written into a device scalar before every
    step as the single-seed executor writes it (``before_train_step``);
    each seed's targets go with it to its member;
  * learning rate: a plateau scheduler per seed, stepped while the seed is
    active; each seed's parameters are one parameter group with a device
    rate of its own, so one seed's drop changes its rate only and the
    captured step reads it without a second capture;
  * clipping: each seed's own global norm (optax's rule under vmap; the
    members' seeds one seed at a time, as their single-seed steps clip);
  * early stop: stopped seeds keep computing, their best snapshot frozen;
    the loop ends when every seed has stopped;
  * best snapshot: parameters and optimizer state, written per seed in
    the port's checkpoint format to ``seed_cache_path``, where the port's
    ``run_model --train false --exp_id {base}_{seed}`` and
    ``executor.load_model`` read it.

The models take no dummy input here, so a point dataset (``len_*`` all 0,
JAX's ``total_len`` fallback to ``input_window``) needs nothing of its own:
each member is built by its family's builder from the config. On CUDA the
train step, the validation forward and the predict forward replay CUDA
graphs, as the single-seed executor's do (``StepLoops``).
"""

import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from multistgraph_tpu_torch.executor.executor import StepLoops, teacher_forcing_ratio
from multistgraph_tpu_torch.executor.optimizers import (
    build_lr_scheduler,
    build_optimizer,
    clip_by_global_norm,
    clip_grad_groups,
    set_learning_rate,
)
from multistgraph_tpu_torch.models import get_model
from multistgraph_tpu_torch.utils import ensure_dir

__all__ = ["MultiSeedResult", "MultiSeedTrainer", "SeedMembers", "SeedStack", "clip_each_seed",
           "protocol_seeds", "seed_cache_path", "train_multiseed"]


@dataclass
class MultiSeedResult:
    seed: int
    best_epoch: int
    min_val_loss: float
    stopped_epoch: Optional[int]  # early-stop epoch, None if ran to max
    history: List[Dict[str, float]] = field(default_factory=list)
    checkpoint: Optional[str] = None


def seed_cache_path(config, seed, model_name: Optional[str] = None) -> str:
    """Where the port's run_model(model_name, --train false,
    exp_id={base}_{seed}) looks: the pipeline names the file after the
    model name it was called with, which for LSTM and GRU is not the
    config's model class (RNN); `model_name` defaults to the config's."""
    return os.path.join(
        config.get("output_dir", "./outputs"), "{}_{}".format(config.get("exp_id"), seed), "model_cache",
        "{}_{}.pt".format(model_name or config.get("model"), config.get("dataset")))


def protocol_seeds(count: int) -> List[int]:
    """The protocol's seeds 0, 10, 100, 1000, then fillers that skip them
    (bench.py:211-215)."""
    pool = itertools.chain([0, 10, 100, 1000], (s for s in itertools.count(2) if s not in (10, 100, 1000)))
    return list(itertools.islice(pool, count))


def clip_each_seed(optimizer: torch.optim.Optimizer, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm under vmap: each parameter group (one
    seed's parameters) clipped by its own global norm, all in one pass;
    returns the (S,) norms."""
    return clip_grad_groups([group["params"] for group in optimizer.param_groups], max_norm)


class SeedStack(nn.Module):
    """S models of one architecture whose forward is one widened forward:
    (S, B, T, N, F) -> (S, B, Tout, N, D), the parameters stacked on a
    leading seed axis each call (so gradients reach each member's own)."""

    graph_safe = True

    def __init__(self, members: Sequence[nn.Module]):
        super().__init__()
        self.members = nn.ModuleList(members)

    def stacked_parameters(self) -> Dict[str, torch.Tensor]:
        per_seed = [m.seed_parameters() for m in self.members]
        return {name: torch.cat([p[name] for p in per_seed]) for name in per_seed[0]}

    def forward(self, x: torch.Tensor, train: bool = False, generators=None) -> torch.Tensor:
        return self.members[0].forward_seeds(self.stacked_parameters(), x, train, generators)


class SeedMembers(nn.Module):
    """S models of one zoo family whose forward runs each member's own
    forward on its seed's slice: (S, B, T, N, F) -> S outputs (B, Tout, N,
    D), member i drawing from generators[i]; with `targets` (S, B, Tout, N,
    D) and `tf_ratio`, each member's scheduled sampling (DCRNN). The outputs
    stay a tuple, each in its member's own layout (some families return a
    permuted view), so that a seed's loss sums in the order its
    single-seed step sums."""

    def __init__(self, members: Sequence[nn.Module]):
        super().__init__()
        self.members = nn.ModuleList(members)

    def forward(self, x: torch.Tensor, train: bool = False, generators=None, targets=None,
                tf_ratio=None) -> Tuple[torch.Tensor, ...]:
        outs = []
        for i, member in enumerate(self.members):
            extra = {} if targets is None else {"targets": targets[i], "tf_ratio": tf_ratio}
            outs.append(member(x[i], train=train, generator=None if generators is None else generators[i],
                               **extra))
        return tuple(outs)


class MultiSeedTrainer(StepLoops):
    """S seeds of `executor`'s model (its config, dropout rate, loss,
    learner, clipping, scheduled sampling and device) trained by one step
    in the form of the model's ``seed_form`` (module docstring); the
    executor's own model and optimizer are untouched."""

    def __init__(self, executor, seeds: Sequence[int], initial_states=None):
        self.form = getattr(executor.model, "seed_form", None)
        if self.form not in ("widened", "members"):
            raise NotImplementedError(
                "multi-seed training takes a model's seeds as one widened forward or as members, and {} "
                "keeps its graph in buffers the seeds would share: train it per seed".format(
                    type(executor.model).__name__))
        self.config = executor.config
        self.device = executor.device
        self.seeds = [int(s) for s in seeds]
        members = []
        for i, seed in enumerate(self.seeds):
            member = get_model(self.config, executor.data_feature, device=self.device,
                               generator=torch.Generator().manual_seed(seed))
            if initial_states is not None:
                member.load_state_dict(initial_states[i])
            if self.form == "widened":   # the zoo's members take their rate from the config
                member.dropout_rate = executor.model.dropout_rate
            members.append(member)
        self.model = SeedStack(members) if self.form == "widened" else SeedMembers(members)
        self.optimizer = build_optimizer(self.config, [{"params": list(m.parameters())} for m in members],
                                         device=self.device)
        self.generators = tuple(torch.Generator(device=self.device).manual_seed(s) for s in self.seeds)
        pred_loss = executor.pred_loss
        if self.form == "widened":
            self.seed_loss = torch.func.vmap(pred_loss)
            self.shared_target_loss = torch.func.vmap(pred_loss, in_dims=(0, None))
        else:   # each seed's loss as its single-seed step computes it
            self.seed_loss = lambda preds, y: torch.stack([pred_loss(p, t) for p, t in zip(preds, y)])
            self.shared_target_loss = lambda preds, y: torch.stack([pred_loss(p, y) for p in preds])
        self.clip_grad_norm = executor.clip_grad_norm
        self.max_grad_norm = executor.max_grad_norm
        self.cl_decay_steps = executor.cl_decay_steps
        self.global_step = 0
        if executor.tf_ratio is not None:
            self.tf_ratio = torch.tensor(float(teacher_forcing_ratio(self.cl_decay_steps, 0)), device=self.device)
        self.capture_rule = executor.capture_rule
        self.graphs_forward = executor.graphs_forward
        self.graphs_train = executor.graphs_train
        self.graphs = {}
        self._warm_steps = 0
        self._side_stream = torch.cuda.Stream(self.device) if self.graphs_forward else None

    def batch(self, loader, idx) -> Dict[str, torch.Tensor]:
        """Each seed's samples `idx` (S, B) of a device loader's split."""
        idx = torch.as_tensor(idx, device=loader.x.device)
        flat = idx.reshape(-1)
        return {"X": loader.x.index_select(0, flat).unflatten(0, idx.shape),
                "y": loader.y.index_select(0, flat).unflatten(0, idx.shape)}

    def train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step of every seed on its own batch; the (S,)
        losses on the device."""
        self.optimizer.zero_grad(set_to_none=True)
        extra = {}
        if self.tf_ratio is not None:   # scheduled sampling: each seed's targets, the shared ratio
            member = self.model.members[0]
            extra = {"targets": batch["y"][..., member.start_dim: member.end_dim], "tf_ratio": self.tf_ratio}
        losses = self.seed_loss(self.model(batch["X"], train=True, generators=self.generators, **extra),
                                batch["y"])
        losses.sum().backward()
        if self.clip_grad_norm and self.form == "widened":
            clip_each_seed(self.optimizer, self.max_grad_norm)
        elif self.clip_grad_norm:
            for member in self.model.members:
                clip_by_global_norm(member.parameters(), self.max_grad_norm)
        self.optimizer.step()
        return losses.detach()

    def train_epoch(self, loader, perms: Sequence[np.ndarray], lrs: Sequence[float]) -> np.ndarray:
        """One epoch, seed i through its (num_batches, B) permutation
        perms[i] at rate lrs[i]; the (S,) mean batch losses."""
        set_learning_rate(self.optimizer, [float(lr) for lr in lrs])
        losses = self.train_steps(loader, np.stack(perms, axis=1), tuple(float(lr) for lr in lrs))
        return losses.mean(0).cpu().numpy()

    def _shared(self, x: torch.Tensor) -> torch.Tensor:
        """One batch seen by every seed: (S, B, ...)."""
        return x[None].expand((len(self.seeds),) + x.shape)

    @torch.no_grad()
    def valid_epoch(self, loader) -> np.ndarray:
        """Each seed's mean validation loss over the loader in order, (S,)."""
        def step(idx):
            x, y = loader.x.index_select(0, idx), loader.y.index_select(0, idx)
            return self.shared_target_loss(self.model(self._shared(x)), y)

        return self._forward_epoch("valid", loader, step).mean(0).cpu().numpy()

    @torch.no_grad()
    def predict(self, loader) -> np.ndarray:
        """Each seed's model-space predictions (S, samples, Tout, N, D) over
        the loader in order."""
        outs = self._forward_epoch("predict", loader, lambda idx: torch.stack(
            tuple(self.model(self._shared(loader.x.index_select(0, idx))))))
        return outs.transpose(0, 1).flatten(1, 2).float().cpu().numpy()

    def seed_state(self, i: int):
        """Seed i's (model state_dict, optimizer state_dict), copies in the
        single-seed executor's format (``save_model``'s tuple)."""
        def copy(v):
            return v.detach().clone() if torch.is_tensor(v) else v

        model_state = {k: copy(v) for k, v in self.model.members[i].state_dict().items()}
        full = self.optimizer.state_dict()
        ids = full["param_groups"][i]["params"]
        state = {j: {k: copy(v) for k, v in full["state"][pid].items()}
                 for j, pid in enumerate(ids) if pid in full["state"]}
        group = {k: copy(v) for k, v in full["param_groups"][i].items()}
        group["params"] = list(range(len(ids)))
        return model_state, {"state": state, "param_groups": [group]}


def train_multiseed(executor, train_loader, eval_loader, seeds, save: bool = True,
                    initial_states=None, trainer: Optional[MultiSeedTrainer] = None,
                    model_name: Optional[str] = None) -> List[MultiSeedResult]:
    """Train `seeds` jointly through one step per batch (the model's
    ``seed_form``).

    `executor` is a constructed single-seed executor of the port (its
    config, loss, learner and device are reused; its own model is
    untouched). `initial_states` optionally gives each seed's initial
    state dict; `trainer` optionally is a MultiSeedTrainer of `executor`
    and `seeds` to train instead of a new one (its models and graphs stay
    readable afterwards). Returns one MultiSeedResult per seed; with
    save=True each seed's best (model, optimizer) state is written to
    seed_cache_path(config, seed, model_name), `model_name` being the name
    the pipeline will be called with (default the config's model).
    """
    if trainer is None:
        trainer = MultiSeedTrainer(executor, seeds, initial_states)
    config, logger = executor.config, executor._logger
    seeds = trainer.seeds
    count = len(seeds)
    num_batches, batch_size = len(train_loader), train_loader.batch_size
    perm_rngs = [np.random.default_rng(s) for s in seeds]
    schedulers = [build_lr_scheduler(config) for _ in seeds]
    base_lr = config.get("learning_rate", 0.01)
    min_val = np.full(count, np.inf)
    wait = np.zeros(count, dtype=int)
    best_epoch = np.zeros(count, dtype=int)
    stopped = np.full(count, -1, dtype=int)
    results = [MultiSeedResult(seed=s, best_epoch=0, min_val_loss=float("inf"), stopped_epoch=None)
               for s in seeds]
    best = [trainer.seed_state(i) for i in range(count)]

    logger.info("multi-seed training: %d seeds %s in one step (%s)", count, seeds, trainer.form)
    for epoch_idx in range(executor.epochs):
        t0 = time.time()
        trainer.global_step = epoch_idx * num_batches
        perms, lrs = [], []
        for i in range(count):
            order = np.arange(train_loader.num_samples)
            if train_loader.shuffle:
                perm_rngs[i].shuffle(order)
            perms.append(order[: num_batches * batch_size].reshape(num_batches, batch_size))
            lrs.append(schedulers[i].lr_for_epoch(epoch_idx) if schedulers[i] is not None else base_lr)
        train_losses = trainer.train_epoch(train_loader, perms, lrs)
        val_losses = trainer.valid_epoch(eval_loader)

        active = stopped < 0
        improved = (val_losses < min_val) & active
        for i in np.flatnonzero(improved):
            best[i] = trainer.seed_state(i)
        best_epoch[improved] = epoch_idx
        min_val[improved] = val_losses[improved]
        wait[improved] = 0
        wait[active & ~improved] += 1
        for i in range(count):
            if not active[i]:
                continue
            if schedulers[i] is not None:
                schedulers[i].step_plateau(float(val_losses[i]))
            results[i].history.append({"epoch": epoch_idx, "train_loss": float(train_losses[i]),
                                       "val_loss": float(val_losses[i]), "lr": float(lrs[i])})
            if executor.use_early_stop and wait[i] >= executor.patience:
                stopped[i] = epoch_idx
                logger.warning("seed %d early-stopped at epoch %d", seeds[i], epoch_idx)
        logger.info("Epoch [%d/%d] val_loss per seed: %s (%.2fs)", epoch_idx, executor.epochs,
                    np.array2string(val_losses, precision=4), time.time() - t0)
        if executor.use_early_stop and (stopped >= 0).all():
            break

    for i, seed in enumerate(seeds):
        results[i].best_epoch = int(best_epoch[i])
        results[i].min_val_loss = float(min_val[i])
        results[i].stopped_epoch = int(stopped[i]) if stopped[i] >= 0 else None
        if save:
            path = seed_cache_path(config, seed, model_name)
            ensure_dir(os.path.dirname(path))
            torch.save(best[i], path)
            results[i].checkpoint = path
            logger.info("seed %d: best epoch %d (val %.4f) -> %s", seed, best_epoch[i], min_val[i], path)
    return results
