"""Ranks for the port's mesh tests: :func:`spawn` starts them (gloo, a
``FileStore`` under the test's directory, one torch thread a rank, a time
limit), and :func:`suite` is what every rank runs. It imports only torch and
the port, so a rank starts in about a second; the JAX reference is computed
once in the test module and handed over as an ``.npz``."""
import dataclasses
import math
import os

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer, restore_tnn
from repro_torch.configs import tnn_mnist as t_tnn_mnist
from repro_torch.core import network as t_network
from repro_torch.launch import collective_probe as t_probe
from repro_torch.launch import dryrun as t_dryrun
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.launch.mesh import make_mesh_2d, spawn_ranks
from repro_torch.serve.tnn_engine import ClassifyRequest, TNNEngine
from repro_torch.train.tnn_trainer import TNNTrainer
from repro_torch.utils.tracing import collectives_recorded

SITES, B, K = 9, 4, 2
FACTORS = ((4, 1), (2, 2), (1, 4))
IMPLS = ("direct", "pallas", "fused")
TIMEOUT_S = 240.0
SERVE_ARGS = ["--sites", str(SITES), "--slots", "4", "--requests", "10",
              "--train-waves", "2", "--superbatch-k", "2", "--online-stdp",
              "--swap-every", "2", "--device", "cpu"]
TRAIN_ARGS = ["--smoke", "--sites", str(SITES), "--superbatch-k", "2",
              "--device", "cpu"]
MESH_ARGS = ["--mesh", "2x2", "--backend", "gloo"]


def spawn(work_dir, fn, *args, world=4):
    """Every rank's return value of ``fn(*args)``, in rank order."""
    return spawn_ranks(fn, world, work_dir=str(work_dir), device="cpu",
                       backend="gloo", threads=1, timeout_s=TIMEOUT_S, args=args)


def cfg(impl="direct"):
    return t_tnn_mnist.network_config(SITES, 12, 3, impl=impl)


def _state0(ref, c, mesh):
    tree = {"params": {k[7:]: ref[k] for k in ref.files if k.startswith("state0.")},
            "rng": ref["state0_rng"], "wave": ref["state0_wave"]}
    return convert.state_to_local(tree, c, mesh)


def _serve(eng, images):
    for uid in range(len(images)):
        eng.submit(ClassifyRequest(uid=uid, image=images[uid]))
    tables = {eng.version: eng.vote_table.numpy().copy()}
    while eng.pending:
        eng.poll()
        tables[eng.version] = eng.vote_table.numpy().copy()
    return {u: (r.result, r.version) for u, r in eng.done.items()}, tables


def _train(ref, mesh, impl):
    """Two train steps and one K-wave superbatch from the reference's
    state 0, on the rank's windows; gathered."""
    c = cfg(impl)
    spec = t_network.network_mesh_spec(c, mesh)
    T = c.layers[0].column.wave.T
    step = t_network.make_train_step(c, mesh)
    state, zs = _state0(ref, c, mesh), []
    with collectives_recorded() as entries:
        for w in range(2):
            state, z = step(state, spec.local_spikes(torch.from_numpy(ref["x"][w]), T))
            zs.append(mesh.gather_grid(z, spec, row_axis=0, site_axis=1))
    out = {"steps": convert.state_from_local(state, c, mesh),
           "z": torch.stack(zs).numpy(), "entries": list(entries),
           "own": all(w.is_contiguous() and w._base is None
                      for w in state["params"].values())}
    sb = t_network.make_superbatch_step(c, mesh)
    state, z_k = sb(_state0(ref, c, mesh),
                    spec.local_spikes(torch.from_numpy(ref["x"]), T, row_axis=1,
                                      site_axis=2))
    out["sb"] = convert.state_from_local(state, c, mesh)
    out["sb_z"] = mesh.gather_grid(z_k, spec, row_axis=1, site_axis=2).numpy()
    return out


def _engines(ref, mesh, online: bool):
    c = cfg("pallas")
    params = [torch.from_numpy(ref[f"state0.layer_{i:02d}"]) for i in range(2)]
    labels = (ref["lab_imgs"], ref["lab_labs"])
    if not online:
        eng = TNNEngine(c, params, n_slots=B, impl="pallas", device="cpu",
                        superbatch_k=K, mesh=mesh)
        eng.fit(*labels)
        results, tables = _serve(eng, ref["req_imgs"])
        return {"results": results, "vote_table": tables[0],
                "stats": eng.stats()}
    eng = TNNEngine(c, params, n_slots=B, impl="fused", device="cpu",
                    superbatch_k=K, online_stdp=True, swap_every=2, seed=0,
                    mesh=mesh)
    eng.fit(*labels)
    results, tables = _serve(eng, ref["online_imgs"])
    return {"results": results, "tables": tables, "swaps": eng.swaps,
            "shadow": convert.state_from_local(eng.learn_state, c, mesh)}


def _trainer(mesh, ckpt_dir, impl="fused"):
    tcfg = t_tnn_mnist.train_config(
        sites=SITES, smoke=True, wave_batch=B, train_size=4 * B, eval_size=8,
        epochs=1, superbatch_k=K, ckpt_every=2, ckpt_dir=ckpt_dir, log_every=0)
    tr = TNNTrainer(cfg(impl), tcfg, device="cpu", mesh=mesh)
    summary = tr.run()
    return {"state": convert.state_from_local(tr.state, tr.cfg, mesh),
            "vote_table": tr.vote_table.numpy(), "accuracy": summary["accuracy"]}


def _restored(mesh, ckpt_dir):
    c = cfg()
    state, extra = restore_tnn(Checkpointer(ckpt_dir), c, device="cpu", mesh=mesh)
    return {"state": convert.state_from_local(state, c, mesh),
            "vote_table": state["vote_table"].numpy(), "wave": extra["wave"]}


def _launchers(work_dir):
    """Both launchers with ``--mesh 2x2`` (the process group exists, so
    ``make_mesh_2d`` only builds the groups)."""
    srv = t_serve.main(SERVE_ARGS + MESH_ARGS)
    tr = t_train.main(TRAIN_ARGS + MESH_ARGS + ["--ckpt-dir",
                                                os.path.join(work_dir, "launch22")])
    trainer = tr["trainer"]
    return {"serve": {"results": srv.results,
                      "params": [w.numpy() for w in srv.params],
                      "vote_table": srv.vote_table.numpy()},
            "train": convert.state_from_local(trainer.state, trainer.cfg,
                                              trainer.mesh)}


def _colpar(mesh):
    """The dry run's column-parallel cell at 9 sites and 4 images a wave on
    this mesh, gathered (the parent holds it to the unmeshed wave)."""
    out = {}
    for impl in ("pallas", "fused"):
        o = {}
        res = t_dryrun.run_tnn_colpar_cell("tnn_train_8k", mesh, impl=impl, sites=SITES,
                                           batch=B, outputs=o, verbose=False)
        assert res["status"] == "ok", res.get("traceback")
        spec = o["spec"]
        out[impl] = {
            "zs": [mesh.gather_grid(z, spec, row_axis=0, site_axis=1).numpy()
                   for z in o["zs"]],
            "new_params": [mesh.gather_sites(w, spec).numpy() for w in o["new_params"]],
            "collectives": res["collectives"], "mesh": res["mesh"]}
    return out


def suite(ref_path, work_dir):
    """Everything the mesh tests hold against the reference, under every
    factorization of 4 ranks, in one start of the ranks."""
    ref = np.load(ref_path)
    out = {}
    for d, m in FACTORS:
        mesh = make_mesh_2d(d, m, device="cpu", backend="gloo")
        res = {impl: _train(ref, mesh, impl) for impl in IMPLS}
        if (d, m) != (4, 1):
            res["engine"] = _engines(ref, mesh, online=False)
        if (d, m) == (2, 2):
            res["online"] = _engines(ref, mesh, online=True)
            res["trainer"] = _trainer(mesh, os.path.join(work_dir, "ckpt22"))
            eng = TNNEngine.from_checkpoint(ref["jax_ckpt"].item(), cfg(), n_slots=B,
                                            device="cpu", mesh=mesh)
            res["jax_ckpt"] = {"params": convert.params_from_local(eng.params, cfg(), mesh),
                               "vote_table": eng.vote_table.numpy()}
            res["launchers"] = _launchers(work_dir)
            res["probe"] = t_probe.main(["--arch", "tnn-mnist", "--mesh", "2x2",
                                         "--sites", str(SITES), "--device", "cpu",
                                         "--backend", "gloo"])["lines"]
        if (d, m) != (4, 1):
            res["colpar"] = _colpar(mesh)
        if (d, m) == (1, 4):
            res["restored"] = _restored(mesh, os.path.join(work_dir, "ckpt22"))
        out[f"{d}x{m}"] = res
    return out


# ---------------------------------------------------------------------------
# LM sharding: the DTensor train and serve steps on a 2x2 mesh
# ---------------------------------------------------------------------------

# the meshed train and serve steps of one arch a family: dense, MoE, MLA,
# SSM, hybrid, encoder-decoder (with frames), VLM prefix (with embeds)
LM_ARCHS = ("llama3.2-3b", "mixtral-8x22b", "minicpm3-4b", "xlstm-125m", "zamba2-7b",
            "whisper-tiny", "internvl2-76b")
LM_B, LM_S, LM_KV_CHUNK = 4, 16, 8
LM_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)
# serve: a prompt of 13 tokens (it ends inside a rank's block of the cache's
# positions) into a cache of 24 positions, 3 ticks; mixtral's prompt runs
# past its sliding window (16), so the ring buffer rolls and wraps sharded;
# internvl2's 8 prefix embeds, 13 tokens and the ticks fill its cache
# (S + frontend_len + ticks)
LM_CACHE, LM_TICKS = 24, 3
LM_PROMPT = {"mixtral-8x22b": 18}   # 13 tokens otherwise
# the collective probe's prefill cells, at LM_B rows of PROBE_S tokens
PROBE_ARCHS, PROBE_S = ("whisper-tiny", "internvl2-76b"), 12
PIPE = dict(R=8, B=16, D=32, n_micro=4)


def lm_cfg(arch, mesh_shape):
    """The smoke config in float32, tuned to the mesh (``moe_groups`` one a
    data shard) as the launcher tunes it."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.sharding import partition as PT

    return PT.tuned_config(dataclasses.replace(smoke_config(arch), dtype="float32"),
                           mesh_shape)


def lm_extras(cfg, rows):
    """The family's seeded extra inputs, float32: ``frames`` for the
    encoder-decoder, ``embeds`` for the VLM prefix (never zeros)."""
    rng = np.random.default_rng(5)
    if cfg.frontend == "vision_stub":
        return {"embeds": rng.standard_normal((rows, cfg.frontend_len, cfg.d_model),
                                              dtype=np.float32)}
    if cfg.n_enc_layers:
        return {"frames": rng.standard_normal((rows, cfg.enc_seq, cfg.d_model),
                                              dtype=np.float32)}
    return {}


def _np_tree(tree):
    from repro_torch.models.params import tree_map
    from repro_torch.sharding import partition as PT

    return tree_map(lambda t: PT.gather_tensor(t).detach().numpy().copy(), tree)


def _lm_train(ref, arch, mesh, work_dir):
    """Grads at the reference's params and two AdamW steps from them, on
    DTensors; the state after them; for llama its checkpoint too."""
    from repro_torch.sharding import partition as PT
    from repro_torch.sharding.context import use_partitioning
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    c = lm_cfg(arch, mesh)
    opt_cfg = OPT.OptConfig(**LM_OPT)
    prof = PT.RunProfile()
    params = _params(ref, arch)
    state = {"params": params, "opt": OPT.opt_init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32)}
    state = TS.shard_state(state, TS.state_shardings(c, opt_cfg, mesh, prof))
    batches = [{k[len(f"{arch}.b{i}."):]: ref[k] for k in ref.files
                if k.startswith(f"{arch}.b{i}.")} for i in range(2)]
    loss_fn = TS.make_loss_fn(c, TS.TrainConfig(kv_chunk=LM_KV_CHUNK))
    with use_partitioning(PT.device_mesh(mesh), PT.act_rules(mesh, prof)):
        # step 1 by hand (the grads are held too), step 2 by the train step
        b = TS.shard_batch(TS.device_batch(batches[0], "cpu"), mesh, prof)
        loss, aux, grads = TS.value_and_grad(loss_fn, state["params"], b)
        out = {"loss": float(PT.gather_tensor(loss)), "grads": _np_tree(grads)}
        if arch == "llama3.2-3b":
            out["adafactor"] = _adafactor(c, state["params"], grads, mesh, prof)
        _, _, gnorm = OPT.opt_update(grads, state["opt"], state["params"], opt_cfg)
        state["step"].add_(1)
        del grads
    out["metrics"] = [{"loss": float(PT.gather_tensor(aux["loss"])), "loss_total": out["loss"],
                       "grad_norm": float(gnorm)}]
    step = TS.make_train_step(c, opt_cfg, TS.TrainConfig(kv_chunk=LM_KV_CHUNK),
                              mesh=mesh, prof=prof)
    state, m = step(state, batches[1])
    out["metrics"].append({k: float(v) for k, v in m.items()})
    out["state"] = _np_tree(state)
    if arch == "llama3.2-3b":
        ckpt = Checkpointer(os.path.join(work_dir, "lm_ckpt"))
        ckpt.save(2, state, extra={"data_step": 2})
        tree, extra = ckpt.restore(2, _np_tree(state),
                                   TS.state_shardings(c, opt_cfg, mesh, prof))
        from repro_torch.models.params import tree_flatten

        out["restored_blocks_equal"] = all(
            torch.equal(PT.local(a), PT.local(b)) if PT.is_sharded(a)
            else np.array_equal(np.asarray(a), b.numpy())
            for (_, a), (_, b) in zip(tree_flatten(tree), tree_flatten(state)))
        out["restored_extra"] = extra
    return out


def _lm_opt_forced(ref, arch, mesh):
    """``optimizer.opt_update`` fed the reference's params and AdamW state
    after its step 1 and its step-2 grads (taken at those params) scaled by
    the reference's step-2 clip scale, the update's own clip off (so the
    float32 norms' sum orders cannot move the scale): on DTensors placed by
    ``state_shardings``, and in one process on the same inputs as plain
    tensors. Both updates' params, m and v, gathered, and both norms of the
    raw grads."""
    from repro_torch.models.params import tree_flatten
    from repro_torch.sharding import partition as PT
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    opt_cfg = OPT.OptConfig(**LM_OPT)
    sh = TS.state_shardings(lm_cfg(arch, mesh), opt_cfg, mesh, PT.RunProfile())
    scale = float(ref[f"{arch}.scale2"])
    out = {}
    for where in ("mesh", "one"):
        one = {what: _tree(ref, f"{arch}.{what}.") for what in ("p1", "m1", "v1", "g2")}
        state = {"params": one["p1"], "opt": {"m": one["m1"], "v": one["v1"],
                                              "count": torch.ones((), dtype=torch.int32)}}
        grads = one["g2"]
        if where == "mesh":
            state = TS.shard_state(state, sh)
            grads = TS.shard_state({"params": grads}, sh)["params"]
        norm = float(OPT.global_norm(grads))
        for _, g in tree_flatten(grads):
            PT.local(g).mul_(scale)
        OPT.opt_update(grads, state["opt"], state["params"],
                       dataclasses.replace(opt_cfg, clip_norm=math.inf))
        out[where] = _np_tree({"params": state["params"], "m": state["opt"]["m"],
                               "v": state["opt"]["v"], "count": state["opt"]["count"]})
        out[where]["grad_norm"] = norm
    return out


def _adafactor(c, params, grads, mesh, prof):
    """One Adafactor update with int8 compression on the sharded params and
    grads, and the same update unmeshed on their gathered copies: the
    largest difference of any leaf of the state, over its largest value."""
    from repro_torch.models.params import tree_flatten, tree_map
    from repro_torch.sharding import partition as PT
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    opt_cfg = OPT.OptConfig(name="adafactor", compress_grads=True, **LM_OPT)
    whole_p = tree_map(lambda t: PT.gather_tensor(t).clone(), params)
    whole_g = tree_map(lambda t: PT.gather_tensor(t).clone(), grads)
    state = {"params": tree_map(lambda t: t.clone(), whole_p),
             "opt": OPT.opt_init(whole_p, opt_cfg), "step": torch.zeros((), dtype=torch.int32)}
    # a copy: the 0-dim counters are kept, not copied, by shard_state
    sharded = TS.shard_state(tree_map(lambda t: t.clone(), state),
                             TS.state_shardings(c, opt_cfg, mesh, prof))
    sh_g = TS.shard_state({"params": whole_g}, TS.state_shardings(c, opt_cfg, mesh, prof))
    OPT.opt_update(sh_g["params"], sharded["opt"], sharded["params"], opt_cfg)
    OPT.opt_update(whole_g, state["opt"], state["params"], opt_cfg)
    err = 0.0
    for (_, a), (_, b) in zip(tree_flatten(sharded), tree_flatten(state)):
        a = PT.gather_tensor(a).double()
        err = max(err, float((a - b.double()).abs().max()
                             / b.double().abs().max().clamp_min(1e-30)))
    return err


def _unflatten(flat):
    """``{"a/b/c": array}`` -> nested dicts of float32 tensors."""
    tree = {}
    for key, a in flat.items():
        node = tree
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = torch.from_numpy(np.array(a))
    return tree


def _tree(ref, prefix):
    """The ``.npz`` entries under ``prefix``, as nested float32 tensors."""
    return _unflatten({k[len(prefix):]: ref[k] for k in ref.files if k.startswith(prefix)})


def _params(ref, arch):
    return _tree(ref, f"{arch}.params.")


def _lm_serve(ref, arch, mesh):
    """A sharded prefill of the reference's prompt (with the family's
    frames or embeds) into an f32 cache and LM_TICKS decode ticks fed the
    reference's greedy tokens: every tick's logits, and every cache leaf
    after the last, gathered."""
    from repro_torch.models import model as M
    from repro_torch.sharding import partition as PT
    from repro_torch.train import train_step as TS

    c = lm_cfg(arch, mesh)
    prof = PT.RunProfile()
    params = PT.shard_tree(_params(ref, arch), TS.param_shardings(c, mesh, prof))
    cache = M.init_cache(c, LM_B, LM_CACHE, torch.float32, "cpu")
    cache = PT.shard_tree(cache, TS.cache_shardings(c, cache, mesh, prof))
    prefill, decode = TS.make_serve_steps(c, kv_chunk=LM_KV_CHUNK, mesh=mesh, prof=prof)
    tokens = torch.from_numpy(ref[f"{arch}.serve.tokens"]).long()
    extras = {k: torch.from_numpy(ref[f"{arch}.serve.{k}"]) for k in ("embeds", "frames")
              if f"{arch}.serve.{k}" in ref.files}
    pos = tokens.shape[1] + (extras["embeds"].shape[1] if "embeds" in extras else 0)
    logits = []
    with torch.no_grad():
        lg, _ = prefill(params, tokens, cache, **extras)
        logits.append(PT.gather_tensor(lg).numpy())
        for t in range(LM_TICKS):
            tok = torch.from_numpy(ref[f"{arch}.serve.next{t}"]).long()
            lg, _ = decode(params, tok, pos + t, cache)
            logits.append(PT.gather_tensor(lg).numpy())
    return {"logits": np.stack(logits), "cache": _np_tree(cache)}


def _probe_serve(ref, arch, mesh):
    """The collective probe's prefill cell at 2x2 (the smoke config in f32,
    its inputs from the reference's specs), and the meshed serve's prefill
    of the reference's params on the same inputs: both logits, gathered."""
    from repro_torch.configs import cell_by_name
    from repro_torch.sharding import partition as PT
    from repro_torch.train import train_step as TS

    args = t_probe.parse_args([
        "--arch", arch, "--cell", "prefill_32k", "--smoke", "--repeat", "2", "--mesh", "2x2",
        "--backend", "gloo", "--device", "cpu", "--batch", str(LM_B), "--seq", str(PROBE_S),
        "--dtype", "float32", "--kv-chunk", str(LM_KV_CHUNK)])
    probe = t_probe.probe_lm(args, mesh=mesh)
    c = lm_cfg(arch, mesh)
    inputs = t_probe.serve_inputs(c, cell_by_name("prefill_32k"), LM_B, PROBE_S, "cpu")
    cache = inputs.pop("cache")
    prof = PT.RunProfile()
    cache = PT.shard_tree(cache, TS.cache_shardings(c, cache, mesh, prof))
    params = PT.shard_tree(_params(ref, arch), TS.param_shardings(c, mesh, prof))
    prefill, _ = TS.make_serve_steps(c, kv_chunk=LM_KV_CHUNK, mesh=mesh, prof=prof)
    with torch.no_grad():
        lg, _ = prefill(params, cache=cache, **inputs)
    return {"probe": probe["result"].numpy(), "serve": PT.gather_tensor(lg).numpy()}


def _lrnn_rows(mesh):
    """``ssm.lrnn_rows`` on DTensors (rows over the data axis, heads over
    the model axis) against ``chunked_lrnn`` on the whole tensors, seeded:
    the outputs and every input's grad, each as its largest difference over
    its largest value."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.models import ssm
    from repro_torch.sharding import partition as PT

    g = torch.Generator().manual_seed(3)
    B, S, H, N, P = 4, 40, 4, 8, 8   # S not a multiple of the chunk
    whole = [-2 * torch.rand(B, S, H, generator=g)] + [
        torch.randn(*shape, generator=g) for shape in
        ((B, S, H, N), (B, S, H, N), (B, S, H, P), (B, H, N, P))]
    gy, gh = torch.randn(B, S, H, P, generator=g), torch.randn(B, H, N, P, generator=g)
    whole = [t.requires_grad_() for t in whole]
    y, h = ssm.chunked_lrnn(*whole, chunk=16)
    ((y * gy).sum() + (h * gh).sum()).backward()
    dm = PT.device_mesh(mesh)
    dts = [distribute_tensor(t.detach(), dm, [Shard(0), Shard(2)]).requires_grad_()
           for t in whole]
    y2, h2 = ssm.lrnn_rows(*dts, chunk=16)
    ((y2 * distribute_tensor(gy, dm, y2.placements)).sum()
     + (h2 * distribute_tensor(gh, dm, h2.placements)).sum()).backward()

    def rel(a, b):
        a = PT.gather_tensor(a.detach())
        return float((a - b.detach()).abs().max() / b.detach().abs().max())

    return {"y": rel(y2, y), "h": rel(h2, h),
            **{f"grad{i}": rel(d.grad, w.grad) for i, (d, w) in enumerate(zip(dts, whole))}}


def _mamba_conv(mesh):
    """``ssm._causal_conv`` on DTensors placed as in the Mamba2 train step
    (rows over the data axis, channels over the model axis; the conv
    weights' channels over the model axis) against the conv on the whole
    tensors, seeded: the output and every input's grad, each as its largest
    difference over its largest value; and whether any pad op was handed a
    DTensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from torch.overrides import TorchFunctionMode

    from repro_torch.models import ssm
    from repro_torch.sharding import partition as PT

    class Pads(TorchFunctionMode):
        saw_dtensor = False

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if "pad" in getattr(func, "__name__", "") and any(
                    isinstance(a, DTensor) for a in args):
                Pads.saw_dtensor = True
            return func(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(5)
    B, S, C, K = 4, 12, 8, 4
    whole = [torch.randn(*shape, generator=g).requires_grad_()
             for shape in ((B, S, C), (K, C), (C,))]
    gy = torch.randn(B, S, C, generator=g)
    y = ssm._causal_conv(*whole)
    (y * gy).sum().backward()
    dm = PT.device_mesh(mesh)
    dts = [distribute_tensor(t.detach(), dm, pl).requires_grad_() for t, pl in zip(
        whole, ([Shard(0), Shard(2)], [Replicate(), Shard(1)], [Replicate(), Shard(0)]))]
    with Pads():
        y2 = ssm._causal_conv(*dts)
        (y2 * distribute_tensor(gy, dm, y2.placements)).sum().backward()

    def rel(a, b):
        return float((PT.gather_tensor(a.detach()) - b.detach()).abs().max()
                     / b.detach().abs().max())

    return {"y": rel(y2, y), "pad_saw_dtensor": Pads.saw_dtensor,
            **{f"grad{i}": rel(d.grad, w.grad) for i, (d, w) in enumerate(zip(dts, whole))}}


def _pad_blocks(mesh):
    """``partition.pad_blocks`` as MLA pads V's head dim (``layers.mla_prefill``,
    (B, S, H, vd) up to the q/k head dim) on DTensors: rows over the data
    axis and heads over the model axis, then the padded dim itself over the
    model axis; each against ``F.pad`` of the whole tensor, forward and grad
    (their largest differences, exactly 0 when right), and whether any pad
    op was handed a DTensor."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    from torch.overrides import TorchFunctionMode

    from repro_torch.sharding import partition as PT

    class Pads(TorchFunctionMode):
        saw_dtensor = False

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if "pad" in getattr(func, "__name__", "") and any(
                    isinstance(a, DTensor) for a in args):
                Pads.saw_dtensor = True
            return func(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(6)
    v = torch.randn(4, 6, 4, 8, generator=g)
    gy = torch.randn(4, 6, 4, 12, generator=g)
    whole = v.clone().requires_grad_()
    (F.pad(whole, (0, 4)) * gy).sum().backward()
    dm = PT.device_mesh(mesh)
    out = {}
    for name, places in (("heads", [Shard(0), Shard(2)]), ("padded_dim", [Shard(0), Shard(3)])):
        dv = distribute_tensor(v, dm, places).requires_grad_()
        with Pads():
            y = PT.pad_blocks(dv, (0, 4))
            (y * distribute_tensor(gy, dm, y.placements)).sum().backward()
        out[name] = [float((PT.gather_tensor(y.detach()) - F.pad(v, (0, 4))).abs().max()),
                     float((PT.gather_tensor(dv.grad) - whole.grad).abs().max())]
    out["pad_saw_dtensor"] = Pads.saw_dtensor
    return out


def _slstm_rows(mesh):
    """``ssm._slstm_rows`` (the serve steps' sLSTM scan: a prefill of 5
    steps and a decode tick's one) on DTensors placed as the serve steps
    place them (rows and the cache's state over the data axis, the
    recurrent weight's heads over the model axis) against the scan on the
    whole tensors, seeded: each output's largest difference over its
    largest value, and whether the cell was handed a DTensor."""
    import dataclasses

    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.configs import smoke_config
    from repro_torch.models import ssm
    from repro_torch.sharding import partition as PT

    cfg = dataclasses.replace(smoke_config("xlstm-125m"), dtype="float32")
    H, d = cfg.n_heads, cfg.d_model
    g = torch.Generator().manual_seed(9)
    state = (0.5 * torch.randn(4, d, generator=g), 1 + torch.rand(4, d, generator=g),
             0.5 * torch.randn(4, d, generator=g), 0.1 * torch.randn(4, d, generator=g))
    wr = 0.1 * torch.randn(H, d // H, 4 * d // H, generator=g)
    dm = PT.device_mesh(mesh)
    rows = [Shard(0), Replicate()]
    cell, saw = ssm._slstm_cell, [False]

    def watched(carry, xt, p, cfg_):
        saw[0] |= any(isinstance(t, DTensor) for t in (*carry, xt, p["wr"]))
        return cell(carry, xt, p, cfg_)

    out = {}
    for S in (5, 1):
        pre = torch.randn(4, S, 4 * d, generator=g)
        want = ssm._slstm_scan(pre, state, {"wr": wr}, cfg)
        ssm._slstm_cell = watched
        try:
            got = ssm._slstm_rows(distribute_tensor(pre, dm, rows),
                                  tuple(distribute_tensor(t, dm, rows) for t in state),
                                  {"wr": distribute_tensor(wr, dm, [Replicate(), Shard(0)])}, cfg)
        finally:
            ssm._slstm_cell = cell
        out[S] = [float((PT.gather_tensor(a) - b).abs().max() / b.abs().max())
                  for a, b in zip((*got[0], got[1]), (*want[0], want[1]))]
    out["cell_saw_dtensor"] = saw[0]
    return out


def _lrnn_decode(mesh):
    """``ssm.lrnn_decode_step`` on DTensors placed as the Mamba2 decode's
    (the state's rows over the data axis, its heads over the model axis)
    against the step on the whole tensors, seeded: each output's largest
    difference over its largest value."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.models import ssm
    from repro_torch.sharding import partition as PT

    g = torch.Generator().manual_seed(4)
    B, H, N, P = 4, 4, 8, 8
    whole = [-2 * torch.rand(B, H, generator=g)] + [
        torch.randn(*shape, generator=g) for shape in ((B, H, N), (B, H, N), (B, H, P),
                                                       (B, H, N, P))]
    y, h = ssm.lrnn_decode_step(*whole)
    dm = PT.device_mesh(mesh)
    y2, h2 = ssm.lrnn_decode_step(*(distribute_tensor(t, dm, [Shard(0), Shard(1)])
                                    for t in whole))
    return {k: float((PT.gather_tensor(a) - b).abs().max() / b.abs().max())
            for k, a, b in (("y", y2, y), ("h", h2, h))}


def _pipeline(ref):
    """``pipeline_apply`` over the 4 ranks as stages: forward, and the
    grads of sum(out^2) with respect to this stage's layers; and the same
    layers run one after another in this process."""
    import torch.distributed as dist

    from repro_torch.sharding.pipeline import pipeline_apply

    P = dist.get_world_size()
    s = dist.get_rank()
    per = PIPE["R"] // P
    whole = {k: torch.from_numpy(ref[f"pipe.{k}"]) for k in ("w", "b")}
    params = {k: v[s * per:(s + 1) * per].clone().requires_grad_() for k, v in whole.items()}
    x = torch.from_numpy(ref["pipe.x"])

    def layer(pr, h):
        return torch.tanh(h @ pr["w"] + pr["b"])

    out = pipeline_apply(layer, params, x, None, PIPE["n_micro"])
    (out ** 2).sum().backward()
    seq_p = {k: v.clone().requires_grad_() for k, v in whole.items()}
    h = x
    for r in range(PIPE["R"]):
        h = layer({k: v[r] for k, v in seq_p.items()}, h)
    (h ** 2).sum().backward()
    return {"out": out.detach().numpy(), "grads": {k: v.grad.numpy() for k, v in params.items()},
            "seq_out": h.detach().numpy(),
            "seq_grads": {k: v.grad[s * per:(s + 1) * per].numpy() for k, v in seq_p.items()}}


def _gloo_cuda_check(mesh):
    """DTensor's collectives (all-gather, reduce-scatter, all-reduce,
    shard-to-shard) with gloo's own kernels, then with
    ``sharding.gloo_cuda``'s registered for the CPU key: equal bit for bit.
    Installed last: the rest of the suite runs on gloo's own."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.sharding import gloo_cuda
    from repro_torch.sharding import partition as PT

    dm = PT.device_mesh(mesh)
    g = torch.Generator().manual_seed(11 + torch.distributed.get_rank())
    x = torch.randn(8, 6, generator=g)

    def run():
        from torch.distributed.tensor import DTensor

        t = DTensor.from_local(x, dm, (Shard(0), Shard(1)), run_check=False)
        p = DTensor.from_local(x, dm, (Partial(), Partial()), run_check=False)
        return [t.full_tensor(), t.redistribute(dm, (Shard(1), Shard(0))).to_local(),
                p.redistribute(dm, (Shard(0), Replicate())).to_local(),
                p.full_tensor()]

    want = run()
    gloo_cuda.install("CPU")
    return all(torch.equal(a, b) for a, b in zip(want, run()))


def lm_suite(ref_path, work_dir):
    """The LM mesh tests' rank body: one start of 4 ranks on a 2x2 mesh."""
    ref = np.load(ref_path)
    mesh = make_mesh_2d(2, 2, device="cpu", backend="gloo")
    out = {arch: _lm_train(ref, arch, mesh, work_dir) for arch in LM_ARCHS}
    out["opt_forced"] = {arch: _lm_opt_forced(ref, arch, mesh) for arch in LM_ARCHS}
    out["serve"] = {arch: _lm_serve(ref, arch, mesh) for arch in LM_ARCHS}
    out["probe"] = {arch: _probe_serve(ref, arch, mesh) for arch in PROBE_ARCHS}
    out["lrnn_rows"] = _lrnn_rows(mesh)
    out["lrnn_decode"] = _lrnn_decode(mesh)
    out["mamba_conv"] = _mamba_conv(mesh)
    out["pad_blocks"] = _pad_blocks(mesh)
    out["slstm_rows"] = _slstm_rows(mesh)
    out["pipeline"] = _pipeline(ref)
    d = os.path.join(work_dir, "lm_launch")
    args = ["--arch", "llama3.2-3b", "--smoke", "--batch", "4", "--seq", "16",
            "--ckpt-dir", d, "--device", "cpu"] + MESH_ARGS
    t_train.main(args + ["--steps", "1"])
    tr = t_train.main(args + ["--steps", "2"])["trainer"]
    out["launch"] = {"state": _np_tree(tr.state), "step": tr.step}
    d = os.path.join(work_dir, "lm_launch_hybrid")
    tr = t_train.main(["--arch", "zamba2-7b", "--smoke", "--batch", "4", "--seq", "16",
                       "--steps", "1", "--ckpt-dir", d, "--device", "cpu"]
                      + MESH_ARGS)["trainer"]
    out["launch_hybrid"] = {"state": _np_tree(tr.state), "step": tr.step}
    out["gloo_cuda_equal"] = _gloo_cuda_check(mesh)
    return out
