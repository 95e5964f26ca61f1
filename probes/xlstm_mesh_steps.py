"""xlstm-125m meshed 2x2 (4 gloo ranks) against one process: per-leaf param readings
after two AdamW steps, as chip_smoke's lm_mesh family hold reads them.

``python3 probes/xlstm_mesh_steps.py cuda`` (4 gloo ranks sharing the card)
or ``... cpu``."""
import dataclasses, os, sys, tempfile
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
WORK = os.path.join(ROOT, "build")
from repro_torch.configs import smoke_config
from repro_torch.sharding import partition as PT
from repro_torch.train import optimizer as OPT, train_step as TS
from repro_torch.data.tokens import TokenStream
from repro_torch import random as R
from repro_torch.models.params import tree_flatten
from repro_torch.launch.mesh import make_mesh_2d, spawn_ranks

ARCHS = ["xlstm-125m"]
DEV = sys.argv[1] if len(sys.argv) > 1 else "cpu"
OPTC = dict(lr=1e-3, warmup_steps=1, total_steps=2)

def cfg_for(arch, mesh):
    return PT.tuned_config(dataclasses.replace(smoke_config(arch), dtype="float32"), mesh)

def batches(cfg):
    s = TokenStream(cfg.vocab_size, 4, 16, seed=0)
    return [dict(s.batch_at(i)) for i in range(2)]

def run(arch, mesh=None):
    cfg = cfg_for(arch, mesh if mesh is not None else {"data": 2, "model": 2})
    oc = OPT.OptConfig(**OPTC)
    sh = TS.state_shardings(cfg, oc, mesh) if mesh is not None else None
    st = TS.init_state(cfg, oc, R.PRNGKey(0), DEV if mesh is None else mesh.device, sh)
    step = TS.make_train_step(cfg, oc, TS.TrainConfig(kv_chunk=8), mesh=mesh)
    p0 = {p: PT.gather_tensor(t).detach().cpu().clone() for p, t in tree_flatten(st["params"])}
    mets = []
    for b in batches(cfg):
        st, m = step(st, b)
        mets.append({k: float(v) for k, v in m.items()})
    end = {p: PT.gather_tensor(t).detach().cpu().clone() for p, t in tree_flatten(st["params"])}
    nu = {p: PT.gather_tensor(t).detach().cpu().clone() for p, t in tree_flatten(st["opt"]["nu"])} if "nu" in st["opt"] else {}
    mu = {p: PT.gather_tensor(t).detach().cpu().clone() for p, t in tree_flatten(st["opt"]["mu"])} if "mu" in st["opt"] else {}
    return {"p0": p0, "end": end, "mets": mets, "nu": nu, "mu": mu}

def ranks():
    mesh = make_mesh_2d(2, 2, device=DEV, backend="gloo")
    return {a: run(a, mesh) for a in ARCHS}

if __name__ == "__main__":
    os.makedirs(WORK, exist_ok=True)
    torch.set_num_threads(1)
    got = spawn_ranks(ranks, 4, work_dir=tempfile.mkdtemp(dir=WORK), device=DEV,
                      backend="gloo", threads=1, timeout_s=600, args=())[0]
    for a in ARCHS:
        one = run(a)
        g = got[a]
        print(a, "metrics one", one["mets"], "\n  mesh", g["mets"])
        rows = []
        for p in one["end"]:
            d = (g["end"][p] - one["end"][p]).double()
            mv = (one["end"][p] - one["p0"][p]).double()
            rms = float(mv.pow(2).mean().sqrt())
            rows.append((float(d.pow(2).mean().sqrt()) / max(rms, 1e-30), float(d.abs().max()) / 1e-3, p, tuple(d.shape), rms))
        rows.sort(reverse=True)
        for r in rows[:6]:
            print(f"  {r[2]} {r[3]}: rms diff / move {r[0]:.4g} (x1e-3 tol: {r[0]/1e-3:.3f}), max diff / lr {r[1]:.4g}, move rms {r[4]:.3g}")
        p = rows[0][2]
        d = (g["end"][p] - one["end"][p]).double().flatten()
        mv = (one["end"][p] - one["p0"][p]).double().flatten()
        idx = d.abs().argsort(descending=True)[:8]
        nu = one["nu"].get(p); mu = one["mu"].get(p)
        print("  worst leaf elements: diff, move, p0, nu, mu")
        for i in idx.tolist():
            print(f"    {i}: {d[i]:.3g} {mv[i]:.3g} {float(one['p0'][p].flatten()[i]):.4g} "
                  f"{float(nu.flatten()[i]) if nu is not None else 'na'} {float(mu.flatten()[i]) if mu is not None else 'na'}")
        frac = float((d.abs() > 1e-6).double().mean())
        print(f"  share of the worst leaf's elements off by > 1e-6: {frac:.4f}; n={d.numel()}")
