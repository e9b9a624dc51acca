"""AdamW with float32 master weights (mixed-precision training) and the
gradient-accumulation train step, after the JAX package's
``training/optimizer.py``.

The optimizer state is ``dict(mu, nu, master, step)``: float32 moments and
masters shaped like the parameters, and a 0-d int32 step.  `adamw_update`
updates the state's tensors IN PLACE (the JAX package returns new arrays;
in place keeps one copy of the float32 state on the card) and returns new
parameter tensors; the ``params`` passed in are never written.  The JAX
package shards this state over a mesh (ZeRO-1); here it lives with the
parameters on one device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.roofline.cost import trips
from repro_torch.training.tree import leaves, tree_map, unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> Dict:
    dev = leaves(params)[0].device
    return dict(
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                        params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig) -> Tuple[Dict, Dict]:
    """One AdamW step: the gradients clipped by their global norm (float32),
    bias-corrected moments, decoupled weight decay on the master.  Returns
    (new params in each leaf's dtype, the state, updated in place)."""
    step = state["step"] + 1
    g32 = [g.float() for g in leaves(grads)]
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in g32))
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for m, v, w, g in zip(leaves(state["mu"]), leaves(state["nu"]),
                          leaves(state["master"]), g32):
        g = g * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        w.sub_(cfg.lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                         + cfg.weight_decay * w))
    state["step"] = step
    new_params = tree_map(lambda w, p: w.to(p.dtype, copy=True),
                          state["master"], params)
    return new_params, state


def value_and_grad(model, params, batch, **loss_kw):
    """(loss, the gradients in leaf order) of ``model.loss`` at ``params``,
    which are left as they are: the loss sees detached leaves that require
    grad.  A leaf the loss does not reach gets zeros, as under JAX."""
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = model.loss(unflatten(params, live), batch, **loss_kw)
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


def make_train_step(model, cfg: AdamWConfig = AdamWConfig(),
                    n_microbatches: int = 8):
    """Gradient-accumulation train step: the batch (a dictionary of arrays
    or tensors, split along dim 0) in ``n_microbatches`` microbatches
    (bounds activation memory), their gradients accumulated in float32
    and divided by n, then one AdamW update.  n_microbatches=1 disables
    accumulation; a batch that n does not divide raises ValueError, as
    the reference's reshape does.  The step returns (params, opt_state,
    loss), the loss the mean of the microbatches' (a 0-d float32
    tensor)."""
    def train_step(params, opt_state, batch):
        dev = leaves(params)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if n_microbatches == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            n = n_microbatches
            B = next(iter(batch.values())).shape[0]
            if B % n:
                raise ValueError(f"a batch of {B} does not split into "
                                 f"{n} microbatches")
            m = B // n
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves(params)]
            losses = []
            micro = trips(n)
            for i in micro:
                mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                loss, g = value_and_grad(model, params, mb)
                for a, x in zip(acc, g):
                    a.add_(x.float())
                losses.append(loss)
                del g
            grads = [a.div_(n) for a in acc]
            loss = micro.stack(losses).mean()
        params, opt_state = adamw_update(params, unflatten(params, grads),
                                         opt_state, cfg)
        return params, opt_state, loss
    return train_step
