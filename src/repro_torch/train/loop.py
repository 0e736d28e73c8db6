"""Train-step factory: loss -> grad -> AdamW, with microbatch accumulation.
Mirrors ``repro.train.loop``.

The params live in the model: a step computes the gradients of
``lm_loss`` with ``torch.autograd.grad`` (nothing is kept in ``.grad``),
runs ``optimizer.update`` and writes the new params into the model under
``torch.no_grad``. With ``n_micro`` > 1 the batch's rows split into
``n_micro`` equal microbatches, run one after another (activation memory
/ n_micro), and the fp32 gradients and the loss accumulate ``/ n_micro``
in the reference's order.

The reference's ``grad_shardings`` (a sharding constraint on the
gradients, ZeRO) belongs to the model's shardings (ROADMAP A13f): the
step takes no such argument.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.train import optimizer as opt


def make_loss_fn(cfg):
    def loss_fn(model, batch):
        return M.lm_loss(model, batch)
    return loss_fn


def _grads(loss_fn, model, batch):
    """((loss, metrics), {name: grad}) of ``loss_fn`` at the model's
    params."""
    named = dict(model.named_parameters())
    with torch.enable_grad():
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), dict(zip(named, grads))


def make_train_step(cfg, adamw: opt.AdamWConfig, n_micro: int = 1):
    """``train_step(model, opt_state, batch) -> (model, new_opt_state,
    metrics)``; the model's params are replaced by the step's new params.
    ``batch``: numpy arrays or tensors, the batch axis first."""
    loss_fn = make_loss_fn(cfg)

    def train_step(model, opt_state, batch):
        if n_micro <= 1:
            (_, metrics), grads = _grads(loss_fn, model, batch)
        else:
            def split(x, i):
                x = torch.as_tensor(x)
                b = x.shape[0]
                return x.reshape(n_micro, b // n_micro, *x.shape[1:])[i]

            grads, loss = None, 0.0
            for i in range(n_micro):
                mb = {k: split(v, i) for k, v in batch.items()}
                (mloss, _), g = _grads(loss_fn, model, mb)
                if grads is None:
                    grads = {k: torch.zeros(v.shape, dtype=torch.float32,
                                            device=v.device)
                             for k, v in g.items()}
                grads = {k: grads[k] + g[k].float() / n_micro for k in g}
                loss = loss + mloss / n_micro
            metrics = {"loss": loss}

        params = dict(model.named_parameters())
        new_params, new_opt, opt_metrics = opt.update(adamw, grads,
                                                      opt_state, params)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_params[k])
        return model, new_opt, {**metrics, **opt_metrics}

    return train_step


def make_eval_step(cfg):
    loss_fn = make_loss_fn(cfg)

    @torch.no_grad()
    def eval_step(model, batch):
        _, metrics = loss_fn(model, batch)
        return metrics

    return eval_step
