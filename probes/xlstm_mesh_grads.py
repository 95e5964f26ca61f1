"""xlstm-125m step-1 grads, meshed 2x2 vs one process, on the worst leaves;
and lrnn_rows on DTensors vs chunked_lrnn on the whole rows.

``python3 probes/xlstm_mesh_grads.py cuda`` (4 gloo ranks sharing the card)
or ``... cpu``."""
import dataclasses, sys, tempfile
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import os
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.configs import smoke_config
from repro_torch.sharding import partition as PT
from repro_torch.sharding.context import use_partitioning
from repro_torch.train import optimizer as OPT, train_step as TS
from repro_torch.data.tokens import TokenStream
from repro_torch import random as R
from repro_torch.models.params import tree_flatten
from repro_torch.models import ssm
from repro_torch.launch.mesh import make_mesh_2d, spawn_ranks

ARCH = "xlstm-125m"
DEV = sys.argv[1] if len(sys.argv) > 1 else "cpu"
LEAVES = [("trunk", "2_slstm", "slstm", "b"), ("trunk", "2_slstm", "slstm", "wx")]

def grads(mesh=None):
    cfg = PT.tuned_config(dataclasses.replace(smoke_config(ARCH), dtype="float32"), {"data": 2, "model": 2})
    oc = OPT.OptConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    dev = DEV if mesh is None else mesh.device
    sh = TS.state_shardings(cfg, oc, mesh) if mesh is not None else None
    st = TS.init_state(cfg, oc, R.PRNGKey(0), dev, sh)
    b = dict(TokenStream(cfg.vocab_size, 4, 16, seed=0).batch_at(0))
    lf = TS.make_loss_fn(cfg, TS.TrainConfig(kv_chunk=8))
    b = TS.device_batch(b, dev)
    if mesh is None:
        loss, aux, g = TS.value_and_grad(lf, st["params"], b)
    else:
        prof = PT.RunProfile()
        with use_partitioning(PT.device_mesh(mesh), PT.act_rules(mesh, prof)):
            b = TS.shard_batch(b, mesh, prof)
            loss, aux, g = TS.value_and_grad(lf, st["params"], b)
    return {p: PT.gather_tensor(t).detach().cpu().clone() for p, t in tree_flatten(g)}

def lrnn_check(mesh):
    from torch.distributed.tensor import distribute_tensor, Shard, Replicate
    dm = PT.device_mesh(mesh)
    g = torch.Generator().manual_seed(3)
    B, S, H, N, P = 4, 40, 4, 8, 8
    mk = lambda *s: torch.randn(*s, generator=g)
    la = -torch.rand(B, S, H, generator=g) * 2
    bb, cc, xv = mk(B, S, H, N), mk(B, S, H, N), mk(B, S, H, P)
    h0 = mk(B, H, N, P)
    whole = [t.to(mesh.device).requires_grad_() for t in (la, bb, cc, xv, h0)]
    y, h = ssm.chunked_lrnn(*whole, chunk=16)
    gy, gh = mk(B, S, H, P).to(mesh.device), mk(B, H, N, P).to(mesh.device)
    (y * gy).sum().add((h * gh).sum()).backward()
    pl = [Shard(0), Shard(2)]
    dts = [distribute_tensor(t.detach(), dm, pl if t.dim() > 2 else [Shard(0), Shard(2)]).requires_grad_() for t in whole]
    y2, h2 = ssm.lrnn_rows(*dts, chunk=16)
    l2 = (y2 * distribute_tensor(gy, dm, y2.placements)).sum() + (h2 * distribute_tensor(gh, dm, h2.placements)).sum()
    l2.backward()
    err = lambda a, b: float((PT.gather_tensor(a) - b).abs().max())
    return {"y": err(y2, y.detach()), "h": err(h2, h.detach()),
            "grads": [err(d.grad, w.grad) for d, w in zip(dts, whole)],
            "y_scale": float(y.abs().max())}

def ranks():
    mesh = make_mesh_2d(2, 2, device=DEV, backend="gloo")
    return {"grads": grads(mesh), "lrnn": lrnn_check(mesh)}

if __name__ == "__main__":
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    torch.set_num_threads(1)
    got = spawn_ranks(ranks, 4, work_dir=tempfile.mkdtemp(dir=os.path.join(ROOT, "build")), device=DEV,
                      backend="gloo", threads=1, timeout_s=600, args=())[0]
    print("lrnn_rows vs chunked_lrnn:", got["lrnn"])
    one = grads()
    for leaf in LEAVES:
        g1, gm = one[leaf].double().flatten(), got["grads"][leaf].double().flatten()
        d = (gm - g1).abs()
        tiny = g1.abs() < 1e-7
        print(leaf, f"max|g| {float(g1.abs().max()):.3g}, grad diff max {float(d.max()):.3g}, "
              f"elements with |g| < 1e-7: {int(tiny.sum())} of {g1.numel()}, "
              f"their |g| max {float(g1[tiny].abs().max()) if tiny.any() else 0:.3g}, "
              f"their diff max {float(d[tiny].max()) if tiny.any() else 0:.3g}")
        if leaf[-1] == "b":
            idx = torch.nonzero(tiny).flatten().tolist()
            print("   tiny-grad indices (of 4*d, gate = i // d):", idx[:40])
            # adam's first step, lr*g/(|g|+eps): what each side's grads make of those elements
            eps, lr = 1e-8, 1e-3
            u1, um = lr * g1 / (g1.abs() + eps), lr * gm / (gm.abs() + eps)
            du = (um - u1)
            print(f"   first-step update diff: rms {float(du.pow(2).mean().sqrt()):.3g}, "
                  f"rms of the update {float(u1.pow(2).mean().sqrt()):.3g}, "
                  f"ratio {float(du.pow(2).mean().sqrt() / u1.pow(2).mean().sqrt()):.3g}")
