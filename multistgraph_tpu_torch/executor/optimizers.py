"""Optimizer, gradient clipping and LR-scheduler factories.

Counterpart of multistgraph_tpu/executor/optimizers.py (ref:
libcity/executor/traffic_state_executor.py:140-198). The optimizers are
``torch.optim``'s, whose update rules are the ones the JAX package rebuilt
in optax: Adam, SGD, Adagrad and RMSprop with weight decay added to the
gradient (L2, not decoupled), momentum as a trace, RMSprop's eps outside
the square root. An unknown learner is Adam without weight decay, as in
JAX. Global-norm clipping (``clip_grad_norm``) runs before the step and
uses optax's ``clip_by_global_norm`` rule, g <- g * max_norm / ||g|| when
||g|| >= max_norm and g otherwise, rather than
``torch.nn.utils.clip_grad_norm_``, which divides by ||g|| + 1e-6 and
clips at every norm. The scheduler is the JAX package's host-side
``LRScheduler``, copied as it is; the executor writes its per-epoch rate
into every ``param_groups[i]["lr"]`` (``set_learning_rate``).

On CUDA the executor records its train step as a CUDA graph
(executor/graphs.py), and a captured step must read its rate and step count
on the device. ``capture_rule`` says, by the learner's name alone, how each
learner's step runs there:
  * "device rate": Adam (and ``sparse_adam``, and an unknown learner, which
    is Adam) and RMSprop are built with ``capturable=True`` and ``foreach``,
    their rate a 0-d f32 device tensor that ``set_learning_rate`` fills;
    the step count and Adam's bias corrections stay on the device (in f32,
    as optax computes them);
  * "re-capture": SGD's torch step reads a tensor rate on the host
    (``alpha=-lr``; its capture fails), so its rate stays a float, baked
    into the graph, and the executor captures the step again when the
    rate changes (between epochs and on a plateau only);
  * "eager": Adagrad's torch step keeps its step count in a CPU tensor
    and advances it on the host: a capture advances it once and no replay
    does (checked on an H100 with torch 2.11), so the optimizer's state
    would drift from an eager run's. Its step stays eager.
The CPU keeps the plain optimizers: CPU tensors refuse ``capturable=True``.
"""

import math
from typing import Callable, Iterable, List, Optional, Sequence

import torch


# how each learner's step runs under the executor on CUDA (module docstring);
# a learner not named here is Adam
CAPTURE_RULES = {"adam": "device rate", "sparse_adam": "device rate", "rmsprop": "device rate",
                 "sgd": "re-capture", "adagrad": "eager"}


def capture_rule(learner: str) -> str:
    """"device rate", "re-capture" or "eager": how the executor runs the
    step of `learner` on CUDA."""
    return CAPTURE_RULES.get(str(learner).lower(), "device rate")


def build_optimizer(config, params: Iterable, device=None) -> torch.optim.Optimizer:
    """The config's optimizer over `params` (parameters, or parameter
    groups: dicts of "params"); on a CUDA `device`, in the form its
    ``capture_rule`` asks for, a device rate of its own for each group."""
    optimizer = _build_optimizer(config, params, device)
    for group in optimizer.param_groups[1:]:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"] = group["lr"].clone()
    return optimizer


def _build_optimizer(config, params, device):
    learner = str(config.get("learner", "adam")).lower()
    lr = config.get("learning_rate", 0.01)
    graph = {}
    if device is not None and torch.device(device).type == "cuda" and capture_rule(learner) == "device rate":
        lr = torch.tensor(float(lr), dtype=torch.float32, device=device)
        graph = {"capturable": True, "foreach": True}
    weight_decay = config.get("weight_decay", 0)
    eps = config.get("lr_epsilon", 1e-8)
    b1 = config.get("lr_beta1", 0.9)
    b2 = config.get("lr_beta2", 0.999)
    alpha = config.get("lr_alpha", 0.99)
    momentum = config.get("lr_momentum", 0)
    params = list(params)
    if learner in ("adam", "sparse_adam"):
        return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay, **graph)
    if learner == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)
    if learner == "adagrad":
        return torch.optim.Adagrad(params, lr=lr, eps=eps, weight_decay=weight_decay)
    if learner == "rmsprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=alpha, eps=eps, momentum=momentum,
                                   weight_decay=weight_decay, **graph)
    # unrecognized -> default Adam, without weight decay (ref :161-164)
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps, **graph)


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the .grad of `params`, in place; returns
    the global norm. The test is made on the device: no host sync."""
    return clip_grad_groups([params], max_norm)[0]


def clip_grad_groups(groups: Sequence[Iterable[torch.nn.Parameter]], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the .grad of each group of parameters,
    in place, each group by its own global norm (optax's rule under vmap
    when each group is one seed's parameters); returns the (groups,) norms.
    One ``_foreach_norm`` over every gradient, then one scale a group,
    whatever the number of groups; the groups hold as many gradients
    each. The test is made on the device: no host sync."""
    grads = [[p.grad for p in params if p.grad is not None] for params in groups]
    if len({len(g) for g in grads}) != 1:
        raise ValueError("the groups hold {} gradients: clip_grad_groups needs as many in each".format(
            [len(g) for g in grads]))
    if not grads[0]:
        return torch.zeros(len(grads))
    per_tensor = torch.stack(torch._foreach_norm([g for group in grads for g in group]))
    norms = torch.linalg.vector_norm(per_tensor.view(len(grads), -1), dim=1)
    scales = torch.where(norms < max_norm, 1.0, max_norm / norms)
    for group, scale in zip(grads, scales.unbind()):
        torch._foreach_mul_(group, scale)
    return norms


def set_learning_rate(optimizer: torch.optim.Optimizer, lr) -> None:
    """Every group's rate to `lr`, a float or one rate per group; a device
    rate is filled in place, so a captured step reads it."""
    rates = lr if isinstance(lr, (list, tuple)) else [lr] * len(optimizer.param_groups)
    for group, rate in zip(optimizer.param_groups, rates, strict=True):
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(rate)
        else:
            group["lr"] = rate


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: dict) -> None:
    """``optimizer.load_state_dict(state)`` that keeps the optimizer's own
    form: its ``capturable`` and ``foreach`` flags and its rate holder (a
    device rate stays the same tensor, filled with the loaded rate), so a
    checkpoint written on either device loads on either."""
    own = optimizer.param_groups
    groups = [dict(saved, lr=float(saved["lr"]), **{k: g[k] for k in ("capturable", "foreach") if k in g})
              for g, saved in zip(own, state["param_groups"])]
    rates = [g["lr"] for g in own]
    optimizer.load_state_dict(dict(state, param_groups=groups))
    for group, rate in zip(optimizer.param_groups, rates):
        if isinstance(rate, torch.Tensor):
            rate.fill_(group["lr"])
            group["lr"] = rate


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class LRScheduler:
    """Host-side per-epoch lr computation matching torch scheduler semantics.

    ``lr_for_epoch(epoch)`` returns the lr to use during 0-based `epoch`;
    plateau mode instead updates state via ``step_plateau(val_loss)`` after
    each epoch.
    """

    def __init__(
        self,
        kind: Optional[str],
        base_lr: float,
        milestones: Optional[List[int]] = None,
        decay_ratio: float = 0.1,
        step_size: int = 10,
        t_max: int = 30,
        eta_min: float = 0.0,
        patience: int = 10,
        threshold: float = 1e-4,
        lr_lambda: Optional[Callable[[int], float]] = None,
    ):
        self.kind = (kind or "none").lower()
        self.base_lr = base_lr
        self.milestones = sorted(milestones or [])
        self.decay_ratio = decay_ratio
        self.step_size = step_size
        self.t_max = t_max
        self.eta_min = eta_min
        self.patience = patience
        self.threshold = threshold
        self.lr_lambda = lr_lambda or (lambda epoch: epoch)
        # plateau state
        self._plateau_lr = base_lr
        self._best = float("inf")
        self._bad_epochs = 0

    def lr_for_epoch(self, epoch: int) -> float:
        if self.kind == "multisteplr":
            hits = sum(1 for m in self.milestones if m <= epoch)
            return self.base_lr * (self.decay_ratio ** hits)
        if self.kind == "steplr":
            return self.base_lr * (self.decay_ratio ** (epoch // self.step_size))
        if self.kind == "exponentiallr":
            return self.base_lr * (self.decay_ratio ** epoch)
        if self.kind == "cosineannealinglr":
            return self.eta_min + (self.base_lr - self.eta_min) * (
                1 + math.cos(math.pi * epoch / self.t_max)
            ) / 2
        if self.kind == "lambdalr":
            return self.base_lr * self.lr_lambda(epoch)
        if self.kind == "reducelronplateau":
            return self._plateau_lr
        return self.base_lr

    def step_plateau(self, val_loss: float) -> None:
        """torch ReduceLROnPlateau (mode=min, rel threshold) epoch update."""
        if self.kind != "reducelronplateau":
            return
        if val_loss < self._best * (1 - self.threshold):
            self._best = val_loss
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
            if self._bad_epochs > self.patience:
                self._plateau_lr *= self.decay_ratio
                self._bad_epochs = 0


def build_lr_scheduler(config) -> Optional[LRScheduler]:
    """Scheduler from config; None when lr_decay is off (ref :167-198)."""
    if not config.get("lr_decay", False):
        return None
    kind = str(config.get("lr_scheduler", "multisteplr")).lower()
    known = {
        "multisteplr", "steplr", "exponentiallr", "cosineannealinglr",
        "lambdalr", "reducelronplateau",
    }
    if kind not in known:
        return None
    return LRScheduler(
        kind,
        base_lr=config.get("learning_rate", 0.01),
        milestones=config.get("steps", []),
        decay_ratio=config.get("lr_decay_ratio", 0.1),
        step_size=config.get("step_size", 10),
        t_max=config.get("lr_T_max", 30),
        eta_min=config.get("lr_eta_min", 0),
        patience=config.get("lr_patience", 10),
        threshold=config.get("lr_threshold", 1e-4),
        lr_lambda=config.get("lr_lambda", None),
    )
