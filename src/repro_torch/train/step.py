"""Train-step builder: loss and gradients through autograd, then AdamW.

The port of ``repro.train.step`` for one card (``mesh=None``).  The
reference jits ``value_and_grad`` + ``adamw_update`` and donates the
parameters and optimizer state; here the step runs eagerly, autograd
takes the gradients (through the flash kernel's hand-written backward on
the card), and :func:`~repro_torch.optim.adamw.adamw_update` writes the
new parameters and moments into the same tensors.  Microbatch
accumulation (``accum > 1``, the reference's ``lax.scan``) sums f32
gradients over the leading micro-batch axis and divides by ``accum``;
the metrics are the last micro-batch's, as the reference's.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils import _pytree as pytree

from ..models import zoo
from ..models.config import ModelConfig
from ..models.parallel import Parallel
from ..optim.adamw import AdamWConfig, adamw_update

__all__ = ["build_train_step"]


def _to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def build_train_step(cfg: ModelConfig, par: Parallel,
                     opt: Optional[AdamWConfig] = None, *, accum: int = 1,
                     impl=None):
    """Returns ``(step, None, None)``, as the reference does without a
    mesh.

    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``;
    ``batch`` holds numpy arrays or tensors (moved to the parameters'
    device), with a leading ``(accum, ...)`` axis when ``accum > 1``."""
    if par.mesh is not None:
        raise NotImplementedError("a sharded train step needs a mesh: it "
                                  "waits for the distributed slice "
                                  "(ROADMAP.md queue 1)")
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    opt = opt or AdamWConfig()
    loss_fn = zoo.train_loss_fn(cfg, par, impl=impl)

    def grads_of(leaves, spec, batch):
        # detached views share the parameters' storage; the update writes
        # into it after the graph is gone
        live = [x.detach().requires_grad_(x.is_floating_point())
                for x in leaves]
        loss, metrics = loss_fn(pytree.tree_unflatten(live, spec), batch)
        want = [x for x in live if x.requires_grad]
        got = iter(torch.autograd.grad(loss, want, allow_unused=True))
        grads = []
        for x in live:
            g = next(got) if x.requires_grad else None
            grads.append(torch.zeros_like(x) if g is None else g)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def step(params, opt_state, batch):
        leaves, spec = pytree.tree_flatten(params)
        batch = _to_device(batch, leaves[0].device)
        if accum == 1:
            _, metrics, grads = grads_of(leaves, spec, batch)
        else:
            grads = None
            for i in range(accum):
                _, metrics, g = grads_of(leaves, spec,
                                         {k: v[i] for k, v in batch.items()})
                if grads is None:
                    grads = [x.float() for x in g]
                else:
                    for a, x in zip(grads, g):
                        a.add_(x.float())
                del g
            for a in grads:
                a.div_(accum)
        grads = pytree.tree_unflatten(grads, spec)
        params, opt_state, opt_metrics = adamw_update(grads, opt_state,
                                                      params, opt)
        return params, opt_state, dict(metrics, **opt_metrics)

    return step, None, None
