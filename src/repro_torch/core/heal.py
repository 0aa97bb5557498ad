"""Healing (paper §4.5): layer-wise knowledge distillation updating only the
dU component of each CUR link matrix (U = U0 + dU; C, R, U0 frozen).

Loss = (1 - alpha) * [ layer-wise MSE + T^2-scaled logit KL ]
       + alpha * CE(labels)
with alpha = 0.1, T = 10 (paper App. B).

Trees follow the JAX package (``repro.core.heal``): a mask is a tree of
bools shaped like the params, and ``partition_params`` splits a tree into
(trainable, frozen) halves with ``None`` placeholders. The step takes its
gradients with ``torch.autograd.grad`` over the trainable leaves only, so
frozen weights never hold a ``.grad`` and get no gradient computed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.bridge import flatten_up_to, tree_map, unflatten_as
from repro_torch.models.model import forward_hidden


# ---------------------------------------------------------------------------
# trainable-parameter partitioning
# ---------------------------------------------------------------------------

TRAINABLE_LEAVES = {
    "dU": ("dU",),
    "lora": ("lora_A", "lora_B"),
    "mora": ("mora",),
    "curlora": ("cU",),
    "all": (),
}


def trainable_mask(params, mode: str):
    """Bool tree: True where the leaf is trainable under ``mode``."""
    if mode == "all":
        return tree_map(lambda _: True, params)
    names = TRAINABLE_LEAVES[mode]

    def walk(node):
        if isinstance(node, dict):
            return {k: (tree_map(lambda _, k=k: k in names, v)
                        if k in names else walk(v))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return False

    return walk(params)


def partition_params(params, mask):
    """Split params into (trainable, frozen) trees (None placeholders)."""
    flat_p = flatten_up_to(params, params)
    flat_m = flatten_up_to(params, mask)
    train = unflatten_as(params, [p if m else None
                                  for p, m in zip(flat_p, flat_m)])
    frozen = unflatten_as(params, [None if m else p
                                   for p, m in zip(flat_p, flat_m)])
    return train, frozen


def combine_params(train, frozen):
    return unflatten_as(train, [t if f is None else f for t, f in zip(
        flatten_up_to(train, train), flatten_up_to(train, frozen))])


def value_and_grad(loss_of, train):
    """(loss, grads) of ``loss_of(train)`` over the tensor leaves of
    ``train`` (``None`` leaves get ``None``): each leaf is re-entered as a
    detached alias that requires grad, so the caller's tensors are not
    touched, and ``torch.autograd.grad`` returns the gradients."""
    flat = flatten_up_to(train, train)
    live = [t.detach().requires_grad_(True) if t is not None else None
            for t in flat]
    loss = loss_of(unflatten_as(train, live))
    inputs = [t for t in live if t is not None]
    grads = iter(torch.autograd.grad(loss, inputs, allow_unused=True,
                                     materialize_grads=True))
    return loss.detach(), unflatten_as(
        train, [None if t is None else next(grads) for t in live])


# ---------------------------------------------------------------------------
# distillation loss
# ---------------------------------------------------------------------------

def kd_loss_fn(student_params, cfg_s, batch, teacher_logits, teacher_hidden,
               *, alpha: float = 0.1, temp: float = 10.0,
               layer_mse: bool = True, logit_kl: bool = True):
    """Layer-wise KD loss. teacher_hidden: (L+1, B, S, D)."""
    s_logits, s_hidden = forward_hidden(student_params, cfg_s, batch)
    s_logits = s_logits.float()
    t_logits = teacher_logits.float()

    distill = 0.0
    if layer_mse:
        diff = s_hidden.float() - teacher_hidden.float()
        distill = distill + torch.mean(torch.square(diff))
    if logit_kl:
        t_lp = F.log_softmax(t_logits / temp, dim=-1)
        s_lp = F.log_softmax(s_logits / temp, dim=-1)
        kl = torch.sum(torch.exp(t_lp) * (t_lp - s_lp), dim=-1)
        distill = distill + (temp ** 2) * torch.mean(kl)

    labels = batch["labels"].long()
    lp = F.log_softmax(s_logits, dim=-1)
    ce = -torch.gather(lp, -1, labels[..., None])[..., 0].mean()
    return (1.0 - alpha) * distill + alpha * ce


def make_heal_step(cfg_s, cfg_t, teacher_params, optimizer, *,
                   mode: str = "dU", alpha: float = 0.1, temp: float = 10.0,
                   layer_mse: bool = True, logit_kl: bool = True):
    """Returns ``step(train, frozen, opt_state, batch) -> (train,
    opt_state, loss)``. Teacher outputs are recomputed per batch under
    ``no_grad`` (at healing scale this beats storing (L+1,B,S,D)
    activations)."""

    def step(train, frozen, opt_state, batch):
        with torch.no_grad():
            t_logits, t_hidden = forward_hidden(teacher_params, cfg_t, batch)

        def loss_of(tr):
            return kd_loss_fn(combine_params(tr, frozen), cfg_s, batch,
                              t_logits, t_hidden, alpha=alpha, temp=temp,
                              layer_mse=layer_mse, logit_kl=logit_kl)

        loss, grads = value_and_grad(loss_of, train)
        train, opt_state = optimizer.update(train, grads, opt_state)
        return train, opt_state, loss

    return step
