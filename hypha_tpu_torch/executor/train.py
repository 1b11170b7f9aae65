"""The inner training step: LR schedules, the optimizer, losses and the
step (counterpart of ``hypha_tpu/executor/train.py``).

The optimizer is optax's chain, written out so its numbers are optax's:
``clip_by_global_norm`` (g is kept when ‖g‖ < max_norm, else scaled by
max_norm/‖g‖, with no epsilon — unlike ``torch.nn.utils.clip_grad_norm_``)
followed by ``adamw`` (bias-corrected moments, eps outside the square
root, decoupled decay of every parameter, all scaled by the scheduled
learning rate). The update with count n (0 for the first) uses
``schedule(n)``. Moments are f32 like the parameters; the optimizer
updates the parameters in place.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..messages import Adam, Loss, LRScheduler, LRSchedulerKind

__all__ = [
    "make_lr_schedule",
    "AdamW",
    "build_optimizer",
    "compute_loss",
    "make_loss_fn",
    "make_train_step",
]


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: constant ``init`` when ``steps`` <= 0."""
    if steps <= 0:
        return lambda n: init

    def sched(n: int) -> float:
        frac = 1.0 - min(max(n, 0), steps) / steps
        return (init - end) * frac + end

    return sched


def _cosine(init: float, decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with alpha 0."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def sched(n: int) -> float:
        t = min(n, decay_steps)
        return init * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))

    return sched


def _join(schedules: list, boundaries: list) -> Callable[[int], float]:
    """optax.join_schedules: each later schedule counts from its boundary."""

    def sched(n: int) -> float:
        out = schedules[0](n)
        for boundary, s in zip(boundaries, schedules[1:]):
            if n >= boundary:
                out = s(n - boundary)
        return out

    return sched


def make_lr_schedule(spec: "LRScheduler | None", base_lr: float) -> Callable[[int], float]:
    """The learning rate of the update with count n (n from 0)."""
    if spec is None or spec.kind is LRSchedulerKind.CONSTANT:
        return lambda n: base_lr
    warmup = max(0, int(spec.warmup_steps))
    total = max(warmup + 1, int(spec.total_steps))
    if spec.kind is LRSchedulerKind.COSINE_WITH_WARMUP:
        return _join([_linear(0.0, base_lr, warmup), _cosine(base_lr, total - warmup)], [warmup])
    if spec.kind is LRSchedulerKind.LINEAR_WITH_WARMUP:
        return _join([_linear(0.0, base_lr, warmup), _linear(base_lr, 0.0, total - warmup)],
                     [warmup])
    if spec.kind is LRSchedulerKind.WSD:
        decay_start = max(warmup, int(spec.decay_start * total))
        return _join(
            [_linear(0.0, base_lr, warmup), lambda n: base_lr,
             _linear(base_lr, 0.0, max(1, total - decay_start))],
            [warmup, decay_start],
        )
    raise ValueError(f"unknown LR schedule {spec.kind}")


class AdamW:
    """optax ``chain(clip_by_global_norm(max_norm), adamw(...))`` over a
    list of parameters, updating them in place. Each update runs as
    ``torch._foreach_*`` operations over groups of parameters of at most
    ``_GROUP`` elements, which bounds the temporaries."""

    _GROUP = 1 << 27  # elements: 512 MiB of f32 per temporary list

    def __init__(self, params, *, lr_schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: "float | None" = 1.0) -> None:
        self.params = [p for p in params]
        self.schedule = lr_schedule
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.groups: list = [[]]
        size = 0
        for i, p in enumerate(self.params):
            if self.groups[-1] and size + p.numel() > self._GROUP:
                self.groups.append([])
                size = 0
            self.groups[-1].append(i)
            size += p.numel()

    @torch.no_grad()
    def step(self, grads) -> torch.Tensor:
        """Apply one update from ``grads`` (one per parameter); returns the
        global norm of the unclipped gradients."""
        grads = [g.float() for g in grads]
        # The global norm: sqrt of the sum of squares of every gradient.
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip = None
        if self.max_grad_norm is not None:
            # optax keeps g below the threshold and takes (g / norm) * max_norm
            # otherwise: g / den * fac with den = fac = 1 keeps g bit for bit,
            # and the choice stays on the device (no host sync).
            keep = norm < self.max_grad_norm
            one = torch.ones_like(norm)
            clip = (torch.where(keep, one, norm),
                    torch.where(keep, one, torch.full_like(norm, self.max_grad_norm)))
        n = self.count + 1
        bc1 = 1.0 - self.b1 ** n
        bc2 = 1.0 - self.b2 ** n
        step_size = -self.schedule(self.count)
        for idx in self.groups:
            p, g, mu, nu = ([xs[i] for i in idx] for xs in (self.params, grads, self.mu, self.nu))
            if clip is not None:
                g = torch._foreach_div(g, clip[0])
                torch._foreach_mul_(g, clip[1])
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            g2 = torch._foreach_mul(g, g)
            del g
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_add_(nu, g2, alpha=1.0 - self.b2)
            den = torch._foreach_div(nu, bc2)
            del g2
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div(mu, bc1)
            torch._foreach_div_(u, den)
            del den
            if self.weight_decay:
                torch._foreach_add_(u, [x.float() for x in p], alpha=self.weight_decay)
            torch._foreach_mul_(u, step_size)
            torch._foreach_add_(p, [x.to(y.dtype) for x, y in zip(u, p)])
        self.count = n
        return norm


def build_optimizer(model_params, adam: Adam, schedule_spec: "LRScheduler | None" = None,
                    max_grad_norm: "float | None" = 1.0, *, mu_dtype=None) -> AdamW:
    """AdamW with the reference's defaults (betas (0.9, 0.999), eps 1e-8)."""
    if mu_dtype is not None:
        raise NotImplementedError("mu_dtype is not ported (ROADMAP.md, Queue 1: mu_dtype)")
    b1, b2 = adam.betas or (0.9, 0.999)
    return AdamW(
        model_params, lr_schedule=make_lr_schedule(schedule_spec, adam.lr), b1=b1, b2=b2,
        eps=adam.epsilon if adam.epsilon is not None else 1e-8,
        weight_decay=adam.weight_decay, max_grad_norm=max_grad_norm,
    )


def compute_loss(kind: Loss, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Loss selector; labels == -100 are ignored by the classification losses."""
    if kind in (Loss.CROSS_ENTROPY, Loss.NLL):
        valid = labels != -100
        safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
        lse = torch.logsumexp(logits.float(), dim=-1)
        picked = torch.gather(logits, -1, safe[..., None])[..., 0].float()
        nll = lse - picked
        return torch.sum(nll * valid) / torch.clamp(valid.sum(), min=1)
    x = logits.float()
    if kind is Loss.MSE:
        return torch.mean((x - labels) ** 2)
    if kind is Loss.MAE:
        return torch.mean(torch.abs(x - labels))
    if kind is Loss.BCE_WITH_LOGITS:
        return torch.mean(torch.clamp(x, min=0) - x * labels + torch.log1p(torch.exp(-x.abs())))
    raise ValueError(f"unknown loss {kind}")


def make_loss_fn(model: Callable, loss_kind: Loss = Loss.CROSS_ENTROPY, *,
                 causal_lm: bool = True, labels_aligned: bool = False) -> Callable:
    """``loss_fn(batch) -> (total, loss, aux)``. Causal LM label layouts:
    ``decoder_input_ids`` and ``labels`` (or ``labels_aligned``): out[t]
    predicts labels[t]; a decoder stream alone: next token within it;
    otherwise next token over ``labels`` (== the inputs by default)."""

    def loss_fn(batch: dict):
        inputs = batch["input_ids"] if "input_ids" in batch else batch["inputs"]
        out = model(inputs)
        aux = torch.zeros((), dtype=torch.float32, device=out.device)
        if causal_lm:
            dec = batch.get("decoder_input_ids")
            explicit = batch.get("labels")
            if explicit is not None and (dec is not None or labels_aligned):
                logits, labels = out, explicit
            elif dec is not None:
                logits, labels = out[:, :-1], dec[:, 1:]
            else:
                target = explicit if explicit is not None else inputs
                logits, labels = out[:, :-1], target[:, 1:]
        else:
            logits, labels = out, batch["labels"]
        loss = compute_loss(loss_kind, logits, labels)
        return loss + aux, loss, aux

    return loss_fn


def make_train_step(model: torch.nn.Module, optimizer: AdamW,
                    loss_kind: Loss = Loss.CROSS_ENTROPY, *, causal_lm: bool = True,
                    labels_aligned: bool = False) -> Callable:
    """``step(batch) -> (loss, total_loss, aux_loss, grad_norm)``: forward,
    loss, backward and one optimizer update, on ``batch`` (tensors already
    on the model's device). The returned values are device scalars; the
    gradients are freed after the update."""
    loss_fn = make_loss_fn(model, loss_kind, causal_lm=causal_lm, labels_aligned=labels_aligned)
    params = optimizer.params

    def step(batch: dict):
        total, loss, aux = loss_fn(batch)
        grads = list(torch.autograd.grad(total, params))
        norm = optimizer.step(grads)
        del grads
        return loss.detach(), total.detach(), aux, norm

    return step
