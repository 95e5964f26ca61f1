"""The LM train step, as ``repro.train.train_step`` builds it: the loss, its
grads by ``torch.autograd``, the optimizer, and micro-step accumulation.

``make_train_step(cfg, opt_cfg)`` returns ``train_step(state, batch) ->
(state, metrics)``. The state is ``{"params", "opt", "step"}``: float32
master params on the device, the optimizer state of ``train.optimizer``, and
``step`` an int32 0-dim host tensor. The step updates the state **in
place** and returns it: a model whose params, grads and moments fill the
card cannot hold a second state. Each step casts the float32 masters to
``cfg.dtype`` once (``cast_params``); autograd carries the grads back
through the cast to the float32 leaves. The trunk runs under
``cfg.remat`` (``models.model``).

A step whose loss is not finite leaves the state as it was: the step reads
the loss (one sync a step) before it applies the update, where the
reference's trainer discards such a step's new state.

``abstract_state`` and ``state_axes`` belong to LM sharding (ROADMAP Queue
1 item 6(e)) and are not here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.params import tree_flatten, tree_map_with_path
from repro_torch.train import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    micro_steps: int = 1  # gradient-accumulation microbatches
    kv_chunk: int = 512  # the chunked attention's KV block
    z_loss: float = 1e-4  # logit normaliser regulariser


def cast_params(params, dtype):
    """The float32 master params cast to the compute dtype, every float32
    leaf (the reference's cast, norm scales included); the tree itself in
    float32."""
    dt = M.as_dtype(dtype)
    if dt == torch.float32:
        return params
    return tree_map_with_path(
        lambda _, p: p.to(dt) if p.dtype == torch.float32 else p, params)


def device_batch(batch, device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy or tensors) on ``device``: token ids int64,
    ``embeds``/``frames`` float32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        t = t.long() if k in ("tokens", "labels") else t.float()
        out[k] = t.to(device)
    return out


def make_loss_fn(cfg: ModelConfig, tc: TrainConfig):
    """``loss_fn(params, batch) -> (loss, {"loss", "tokens"})``: the mean
    cross-entropy over the labels >= 0 (the VLM's prefix positions, which
    carry no labels, sliced off the logits), in float32, plus ``z_loss``
    times the mean squared log-normaliser; ``aux["loss"]`` is the
    cross-entropy alone, ``aux["tokens"]`` the count of labelled tokens."""

    def loss_fn(params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        params = cast_params(params, cfg.dtype)
        logits = M.forward_train(params, cfg, batch["tokens"], embeds=batch.get("embeds"),
                                 frames=batch.get("frames"), kv_chunk=tc.kv_chunk)
        prefix = cfg.frontend_len if cfg.frontend == "vision_stub" else 0
        logits = logits[:, prefix:]
        labels = batch["labels"]
        mask = (labels >= 0).to(torch.float32)
        labels = torch.clamp_min(labels, 0)
        logits_f = logits.to(torch.float32)
        lse = torch.logsumexp(logits_f, dim=-1)
        gold = torch.gather(logits_f, -1, labels[..., None])[..., 0]
        nll = (lse - gold) * mask
        denom = torch.clamp_min(mask.sum(), 1.0)
        loss = nll.sum() / denom
        if tc.z_loss:
            loss = loss + tc.z_loss * (torch.square(lse) * mask).sum() / denom
        return loss, {"loss": nll.sum() / denom, "tokens": denom}

    return loss_fn


def init_state(cfg: ModelConfig, opt_cfg: opt.OptConfig, key, device="cuda") -> Dict[str, Any]:
    """Params drawn from ``key`` on ``device`` (the reference's
    ``init_params``, bit for bit), a zero optimizer state, step 0."""
    params = M.init_params(cfg, key, device)
    return {"params": params, "opt": opt.opt_init(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32)}


def _grads_summed(loss_fn, params, batches):
    """Each batch's (loss, aux), and the float32 grads at ``params`` summed
    over the batches, in the params' tree, zeros for a leaf the loss does
    not read. Autograd adds each batch's grads into the leaves' ``.grad`` in
    place (the first batch's taken as they come: the same bits as a sum from
    zero, up to the sign of a zero), so one grad tree is held however many
    batches there are."""
    flat = tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for _, t in flat]
    by_path = {path: t for (path, _), t in zip(flat, leaves)}
    view = tree_map_with_path(lambda path, _: by_path[path], params)
    out = []
    for batch in batches:
        loss, aux = loss_fn(view, batch)
        torch.autograd.backward(loss, inputs=leaves)
        out.append((loss.detach(), {k: v.detach() for k, v in aux.items()}))
    g_by_path = {path: t.grad if t.grad is not None else torch.zeros_like(t)
                 for (path, _), t in zip(flat, leaves)}
    return out, tree_map_with_path(lambda path, _: g_by_path[path], params)


def value_and_grad(loss_fn, params, batch):
    """(loss, aux, grads) of ``loss_fn`` at ``params``: the grads float32,
    in the params' tree, zeros for a leaf the loss does not read."""
    [(loss, aux)], grads = _grads_summed(loss_fn, params, [batch])
    return loss, aux, grads


def _microbatches(batch, n: int):
    """``n`` slices of every batch entry along its rows, in order."""
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"batch of {rows} rows does not split into {n} micro-steps")
    b = rows // n
    return [{k: v[i * b:(i + 1) * b] for k, v in batch.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, opt_cfg: opt.OptConfig,
                    tc: TrainConfig = TrainConfig()):
    """``train_step(state, batch) -> (state, metrics)``, in place on the
    state. Metrics (0-dim tensors): ``loss`` and ``tokens`` (the loss's aux),
    ``grad_norm`` (after compression, before clipping; NaN where the loss is
    not finite and nothing was applied) and ``loss_total`` (with the
    z-loss). With ``micro_steps > 1`` the batch's rows split into that many
    microbatches, run one after another: their float32 grads summed (into
    one grad tree, as :func:`_grads_summed` holds them), then divided by
    the count; loss and aux their means."""
    loss_fn = make_loss_fn(cfg, tc)

    def train_step(state, batch):
        params = state["params"]
        device = next(t for _, t in tree_flatten(params)).device
        batch = device_batch(batch, device)
        if tc.micro_steps > 1:
            out, grads = _grads_summed(loss_fn, params, _microbatches(batch, tc.micro_steps))
            n = torch.tensor(float(tc.micro_steps), device=device)
            for _, g in tree_flatten(grads):
                g.div_(n)
            loss = torch.stack([l for l, _ in out]).mean()
            aux = {k: torch.stack([a[k] for _, a in out]).mean() for k in out[0][1]}
        else:
            loss, aux, grads = value_and_grad(loss_fn, params, batch)
        if not math.isfinite(float(loss)):
            nan = torch.full((), float("nan"), device=device)
            return state, dict(aux, grad_norm=nan, loss_total=loss)
        _, _, gnorm = opt.opt_update(grads, state["opt"], params, opt_cfg)
        del grads
        state["step"].add_(1)
        return state, dict(aux, grad_norm=gnorm, loss_total=loss)

    return train_step


def make_serve_steps(cfg: ModelConfig, kv_chunk: int = 512, cast_weights: bool = True):
    """``(prefill_fn, decode_fn)`` over ``models.model.prefill`` and
    ``decode_step``. ``cast_weights=False`` skips the float32 -> compute
    dtype cast of every weight a call (the model casts each weight at its
    use either way)."""

    def prefill_fn(params, tokens, cache, embeds=None, frames=None):
        if cast_weights:
            params = cast_params(params, cfg.dtype)
        return M.prefill(params, cfg, tokens, cache, embeds=embeds, frames=frames,
                         kv_chunk=kv_chunk)

    def decode_fn(params, token, pos, cache):
        if cast_weights:
            params = cast_params(params, cfg.dtype)
        return M.decode_step(params, cfg, token, pos, cache)

    return prefill_fn, decode_fn
