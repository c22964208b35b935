"""Masked losses and metrics on torch tensors.

Counterpart of multistgraph_tpu/ops/losses.py (ref: libcity/model/loss.py:17-91),
with its semantics:
  * labels with |label| < min_s are zeroed before masking;
  * mask = labels != null_val (or ~isnan(labels) when null_val is NaN or None);
  * the mask is renormalized by its mean, and NaNs from 0/0 are scrubbed to 0;
  * the elementwise loss is multiplied by the mask, NaN-scrubbed, and averaged
    over all elements.
Thresholding is applied inside every function and never mutates the caller's
labels, as in the JAX package. Every function takes tensors or numpy arrays
(computed in f32 on the tensor's device, the CPU for numpy) and returns a
0-d f32 tensor.
"""

import math

import torch


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a).float()


def _is_nan_null(null_val) -> bool:
    return null_val is None or (isinstance(null_val, float) and math.isnan(null_val))


def _threshold_labels(labels, min_s):
    labels = _f32(labels)
    if min_s:
        labels = torch.where(labels.abs() < min_s, torch.zeros_like(labels), labels)
    return labels


def _normalized_mask(labels, null_val):
    mask = ~torch.isnan(labels) if _is_nan_null(null_val) else labels != null_val
    mask = mask.float()
    mask = mask / mask.mean()
    return torch.where(torch.isnan(mask), torch.zeros_like(mask), mask)


def _masked_mean(elementwise, mask):
    loss = elementwise * mask
    loss = torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)
    return loss.mean()


def masked_mae(preds, labels, null_val=float("nan"), min_s=1e-4):
    preds = _f32(preds)
    labels = _threshold_labels(labels, min_s)
    return _masked_mean((preds - labels).abs(), _normalized_mask(labels, null_val))


def masked_mse(preds, labels, null_val=float("nan"), min_s=1e-4):
    preds = _f32(preds)
    labels = _threshold_labels(labels, min_s)
    return _masked_mean((preds - labels).square(), _normalized_mask(labels, null_val))


def masked_rmse(preds, labels, null_val=float("nan"), min_s=1e-4):
    # the reference thresholds labels, then calls masked_mse without
    # forwarding min_s (loss.py:88-90): the inner call applies the default
    labels = _threshold_labels(labels, min_s)
    return torch.sqrt(masked_mse(preds, labels, null_val=null_val))


def masked_mape(preds, labels, null_val=float("nan"), eps=0, min_s=1e-4):
    preds = _f32(preds)
    labels = _threshold_labels(labels, min_s)
    if _is_nan_null(null_val) and eps != 0:
        return ((preds - labels) / (labels + eps)).abs().mean()
    return _masked_mean(((preds - labels) / labels).abs(), _normalized_mask(labels, null_val))


def log_cosh_loss(preds, labels):
    return torch.log(torch.cosh(_f32(preds) - _f32(labels))).mean()


def huber_loss(preds, labels, delta=1.0):
    residual = (_f32(preds) - _f32(labels)).abs()
    small = 0.5 * residual.square()
    large = delta * residual - 0.5 * delta * delta
    return torch.where(residual <= delta, small, large).mean()


def quantile_loss(preds, labels, delta=0.25):
    preds, labels = _f32(preds), _f32(labels)
    large = delta * (labels - preds)
    small = (1 - delta) * (preds - labels)
    return torch.where(labels >= preds, large, small).mean()


def r2_score(preds, labels):
    """Coefficient of determination, as sklearn.r2_score(labels, preds)."""
    preds, labels = _f32(preds).reshape(-1), _f32(labels).reshape(-1)
    ss_res = (labels - preds).square().sum()
    ss_tot = (labels - labels.mean()).square().sum()
    return 1.0 - ss_res / ss_tot


def explained_variance_score(preds, labels):
    """As sklearn.explained_variance_score(labels, preds)."""
    preds, labels = _f32(preds).reshape(-1), _f32(labels).reshape(-1)
    return 1.0 - torch.var(labels - preds, correction=0) / torch.var(labels, correction=0)


def make_pred_loss(model, scaler):
    """A model's own training loss on a prediction, for every model of the
    port (JAX multi_atgcn.py:1036-1047, ref :422-427): masked MAE on the
    inverse-transformed prediction and truth, null_val 0, the truth cut to
    the model's target channels ``start_dim:end_dim``. ``pred_loss(pred, y)``."""

    def pred_loss(pred, y):
        y_true = y[..., model.start_dim: model.end_dim]
        return masked_mae(scaler.inverse_transform(pred), scaler.inverse_transform(y_true), 0.0)

    return pred_loss


def make_loss_fn(model, scaler):
    """The model's own training loss (``make_pred_loss``) on a batch,
    ``loss_fn(batch, train, generator)``: ``train`` turns dropout on."""
    pred_loss = make_pred_loss(model, scaler)

    def loss_fn(batch, train: bool = True, generator=None):
        return pred_loss(model(batch["X"], train=train, generator=generator), batch["y"])

    return loss_fn
