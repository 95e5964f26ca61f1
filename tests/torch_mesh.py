"""Ranks for the port's mesh tests: :func:`spawn` starts them (gloo, a
``FileStore`` under the test's directory, one torch thread a rank, a time
limit), and :func:`suite` is what every rank runs. It imports only torch and
the port, so a rank starts in about a second; the JAX reference is computed
once in the test module and handed over as an ``.npz``."""
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
