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

On a (data, model) mesh (``mesh=`` a ``launch.mesh.Mesh2D``) the state's
leaves are DTensors placed by ``sharding.partition.param_rules``
(:func:`state_shardings`; :func:`init_state` draws them so), the batch's
rows are sharded over the data axis by ``act_rules``, and the forward runs
under ``sharding.context.use_partitioning``: DTensor's propagation inserts
the FSDP gathers, the tensor-parallel reductions and the grads'
reduce-scatters that GSPMD inserts in the reference. Each grad is brought to
its param's placements before the optimizer, and the metrics come back whole
on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.params import tree_flatten, tree_map, tree_map_with_path
from repro_torch.sharding import partition as PT
from repro_torch.sharding.context import shard_activation, use_partitioning
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
        # on a mesh the vocab is made whole for the gather below (DTensor's
        # gather from a vocab-sharded tensor fails on a 2-D mesh)
        logits = shard_activation(logits, ("batch", "seq", None))[:, prefix:]
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


def init_state(cfg: ModelConfig, opt_cfg: opt.OptConfig, key, device="cuda",
               shardings=None) -> Dict[str, Any]:
    """Params drawn from ``key`` on ``device`` (the reference's
    ``init_params``, bit for bit), a zero optimizer state, step 0. With
    ``shardings`` (:func:`state_shardings`) every leaf is a DTensor: each
    param is drawn whole on the rank's device, its block kept and the rest
    freed before the next leaf, so the peak is one leaf."""
    if shardings is None:
        params = M.init_params(cfg, key, device)
        return {"params": params, "opt": opt.opt_init(params, opt_cfg),
                "step": torch.zeros((), dtype=torch.int32)}
    from repro_torch.models.params import is_spec, materialize

    dev = resolve_device(device)
    specs = M.build_specs(cfg)
    keys = M.param_keys(cfg, key)
    sh = dict(tree_flatten(shardings["params"], _is_sharding))
    params = tree_map_with_path(
        lambda path, s: PT.shard_tensor(materialize(s, keys[path], dev), sh[path]),
        specs, is_spec)
    state = {"params": params, "opt": opt.opt_init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32)}
    return shard_state(state, shardings)


def _is_sharding(x) -> bool:
    return isinstance(x, PT.NamedSharding)


def shard_state(state, shardings):
    """``state`` with every leaf of more than 0 dims that is not yet a
    DTensor placed by its sharding (a copy of the rank's block); 0-dim
    leaves (the counters, on the host) stay as they are."""
    sh = dict(tree_flatten(shardings, _is_sharding))
    return tree_map_with_path(
        lambda path, t: t if PT.is_sharded(t) or t.dim() == 0
        else PT.shard_tensor(t, sh[path]), state)


def abstract_state(cfg: ModelConfig, opt_cfg: opt.OptConfig) -> Dict[str, Any]:
    """The train state as ``meta`` tensors (shapes and dtypes, no storage)."""
    params = M.abstract_params(cfg)
    state = {"params": params, "opt": opt.opt_init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32)}
    return tree_map(lambda t: t.to("meta"), state)


def state_axes(cfg: ModelConfig, opt_cfg: opt.OptConfig) -> Dict[str, Any]:
    """Logical axes for the full train state: the AdamW moments and the
    compression residual mirror the params; Adafactor's factored ``vr``
    drops the last axis and ``vc`` the second to last (``(None,)`` for a
    1-D leaf); the counters have none."""
    paxes = M.param_axes(cfg)
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    if opt_cfg.name == "adamw":
        oaxes: Dict[str, Any] = {"m": paxes, "v": paxes, "count": ()}
    else:
        vr = tree_map(lambda a: tuple(a[:-1]), paxes, is_axes)
        vc = tree_map(lambda a: tuple(a[:-2] + a[-1:]) if len(a) >= 2 else (None,),
                      paxes, is_axes)
        oaxes = {"vr": vr, "vc": vc, "count": ()}
    if opt_cfg.compress_grads:
        oaxes["residual"] = paxes
    return {"params": paxes, "opt": oaxes, "step": ()}


def state_shardings(cfg: ModelConfig, opt_cfg: opt.OptConfig, mesh,
                    prof: PT.RunProfile = PT.RunProfile()):
    """The train state's :class:`~repro_torch.sharding.partition.NamedSharding`
    tree on ``mesh`` under ``param_rules``."""
    return PT.shardings_for_tree(abstract_state(cfg, opt_cfg), state_axes(cfg, opt_cfg),
                                 mesh, PT.param_rules(mesh, prof))


def shard_batch(batch, mesh, prof: PT.RunProfile = PT.RunProfile()):
    """Every batch entry (whole, the same on every rank) as a DTensor whose
    rows are sharded over the data axes where they divide, as the
    reference's ``batch_shard``."""
    dp = PT.mesh_shape(mesh).get("data", 1) * PT.mesh_shape(mesh).get("pod", 1)

    def one(t):
        div = t.dim() > 0 and t.shape[0] % dp == 0
        return PT.shard_tensor(t, PT.batch_sharding(mesh, prof, t.dim(), div))

    return {k: one(v) for k, v in batch.items()}


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
    g_by_path = {path: _grad(t) for (path, _), t in zip(flat, leaves)}
    return out, tree_map_with_path(lambda path, _: g_by_path[path], params)


def _grad(leaf):
    """A leaf's grad, zeros where the loss did not read it; a DTensor grad
    brought to its param's placements (a partial sum over the data axis
    reduce-scattered, as FSDP does)."""
    g = leaf.grad
    if g is None:
        return torch.zeros_like(leaf)
    if PT.is_sharded(g) and tuple(g.placements) != tuple(leaf.placements):
        g = g.redistribute(leaf.device_mesh, leaf.placements)
    return g


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
                    tc: TrainConfig = TrainConfig(), mesh=None,
                    prof: PT.RunProfile = PT.RunProfile()):
    """``train_step(state, batch) -> (state, metrics)``, in place on the
    state. Metrics (0-dim tensors): ``loss`` and ``tokens`` (the loss's aux),
    ``grad_norm`` (after compression, before clipping; NaN where the loss is
    not finite and nothing was applied) and ``loss_total`` (with the
    z-loss). With ``micro_steps > 1`` the batch's rows split into that many
    microbatches, run one after another: their float32 grads summed (into
    one grad tree, as :func:`_grads_summed` holds them), then divided by
    the count; loss and aux their means. With ``mesh`` the state is
    sharded (:func:`state_shardings`), the batch is the global one on
    every rank, and the metrics are whole on every rank."""
    loss_fn = make_loss_fn(cfg, tc)

    def train_step(state, batch):
        params = state["params"]
        device = next(t for _, t in tree_flatten(params)).device
        batch = device_batch(batch, device)
        if tc.micro_steps > 1:
            batches = _microbatches(batch, tc.micro_steps)
            if mesh is not None:
                batches = [shard_batch(b, mesh, prof) for b in batches]
            out, grads = _grads_summed(loss_fn, params, batches)
            out = [(PT.gather_tensor(l), {k: PT.gather_tensor(v) for k, v in a.items()})
                   for l, a in out]
            n = torch.tensor(float(tc.micro_steps), device=device)
            for _, g in tree_flatten(grads):
                PT.local(g).div_(n)
            loss = torch.stack([l for l, _ in out]).mean()
            aux = {k: torch.stack([a[k] for _, a in out]).mean() for k in out[0][1]}
        else:
            if mesh is not None:
                batch = shard_batch(batch, mesh, prof)
            loss, aux, grads = value_and_grad(loss_fn, params, batch)
            loss = PT.gather_tensor(loss)
            aux = {k: PT.gather_tensor(v) for k, v in aux.items()}
        if not math.isfinite(float(loss)):
            nan = torch.full((), float("nan"), device=device)
            return state, dict(aux, grad_norm=nan, loss_total=loss)
        _, _, gnorm = opt.opt_update(grads, state["opt"], params, opt_cfg)
        del grads
        state["step"].add_(1)
        return state, dict(aux, grad_norm=gnorm, loss_total=loss)

    if mesh is None:
        return train_step
    dm, rules = PT.device_mesh(mesh), PT.act_rules(mesh, prof)

    def meshed_step(state, batch):
        # the backward pass (and remat's recompute in it) runs in the
        # context too
        with use_partitioning(dm, rules):
            return train_step(state, batch)

    return meshed_step


def make_serve_steps(cfg: ModelConfig, kv_chunk: int = 512, cast_weights: bool = True,
                     mesh=None, prof: PT.RunProfile = PT.RunProfile()):
    """``(prefill_fn, decode_fn)`` over ``models.model.prefill`` and
    ``decode_step``. ``cast_weights=False`` skips the float32 -> compute
    dtype cast of every weight a call (the model casts each weight at its
    use either way). With ``mesh`` the params and the cache are DTensors
    (:func:`param_shardings`, :func:`cache_shardings`), the tokens are
    whole on every rank and sharded here by rows, the call runs under
    ``act_rules``, and the logits come back as a DTensor."""

    def prefill_fn(params, tokens, cache, embeds=None, frames=None):
        if cast_weights:
            params = cast_params(params, cfg.dtype)
        return M.prefill(params, cfg, tokens, cache, embeds=embeds, frames=frames,
                         kv_chunk=kv_chunk)

    def decode_fn(params, token, pos, cache):
        if cast_weights:
            params = cast_params(params, cfg.dtype)
        return M.decode_step(params, cfg, token, pos, cache)

    if mesh is None:
        return prefill_fn, decode_fn
    dm, rules = PT.device_mesh(mesh), PT.act_rules(mesh, prof)

    def meshed_prefill(params, tokens, cache, embeds=None, frames=None):
        b = shard_batch({k: v for k, v in (("tokens", tokens), ("embeds", embeds),
                                            ("frames", frames)) if v is not None},
                        mesh, prof)
        with use_partitioning(dm, rules):
            return prefill_fn(params, b["tokens"], cache, embeds=b.get("embeds"),
                              frames=b.get("frames"))

    def meshed_decode(params, token, pos, cache):
        with use_partitioning(dm, rules):
            return decode_fn(params, shard_batch({"t": token}, mesh, prof)["t"], pos, cache)

    return meshed_prefill, meshed_decode


def param_shardings(cfg: ModelConfig, mesh, prof: PT.RunProfile = PT.RunProfile()):
    """The param tree's shardings on ``mesh`` under ``param_rules``."""
    return PT.shardings_for_tree(M.abstract_params(cfg), M.param_axes(cfg), mesh,
                                 PT.param_rules(mesh, prof))


def cache_shardings(cfg: ModelConfig, cache, mesh, prof: PT.RunProfile = PT.RunProfile()):
    """A cache tree's shardings on ``mesh`` under ``act_rules`` (its
    ``cache_axes``: KV leaves (batch, kv_seq), recurrent states batch)."""
    return PT.shardings_for_tree(cache, M.cache_axes(cfg, cache), mesh,
                                 PT.act_rules(mesh, prof))
