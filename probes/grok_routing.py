"""grok-1-314b at 2 layers, bf16, capacity factor E/k (no token drops),
served at 4 slots; the recorded requests held to one-slot runs (a) as the
model routes, (b) with the routing fixed (every token to experts 0 and 1,
gates from its own logits), (c) with the router logits in float32; plus
how often the k-th and (k+1)-th bf16 router logits are within one ulp.

On the card (about 80 s, 64 GiB): ``python3 probes/grok_routing.py``; the
smoke config on the CPU: ``python3 probes/grok_routing.py --smoke``."""
import dataclasses, os, sys, time
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src")); sys.path.insert(0, ROOT)
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import moe
from repro_torch.models import model as M
from repro_torch import random as R

SMOKE = "--smoke" in sys.argv
dev = torch.device("cpu" if SMOKE else "cuda")
if not SMOKE:
    from repro_torch.kernels import autotune
    print(autotune.smi_line(), flush=True)
grok = cs.lm_smoke_config("grok-1-314b") if SMOKE else cs.get_lm_config("grok-1-314b")
ek = grok.n_experts / grok.experts_per_token
cut = dataclasses.replace(grok, n_layers=2, layout_repeat=2, moe_capacity_factor=ek)
if SMOKE:
    cut = dataclasses.replace(cut, dtype="bfloat16")
    params = M.init_params(cut, R.PRNGKey(0), dev)
    cfg = cut
else:
    four = ["--requests", "4", "--slots", "4", "--max-new", str(cs.LM_MAX_NEW),
            "--max-len", str(cs.LM_MAX_LEN)]
    rep = launch_serve.serve_lm(launch_serve.parse_args(["--arch", "grok-1-314b", *four]), cfg=cut)
    rep.engine = None
    params, cfg = rep.params, rep.cfg
    cs._free()

real_top_k, real_dispatch = moe.top_k, moe._dispatch
TIES = {"tokens": 0, "within_ulp": 0, "exact": 0}


def counting_top_k(logits, k):
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gap = (vals[..., k - 1] - vals[..., k]).abs()
    ulp = torch.exp2(torch.floor(torch.log2(vals[..., k - 1].abs().clamp_min(1e-30))) - 7)
    TIES["tokens"] += gap.numel()
    TIES["within_ulp"] += int((gap <= ulp).sum())
    TIES["exact"] += int((gap == 0).sum())
    return real_top_k(logits, k)


def fixed_top_k(logits, k):
    idx = torch.arange(k, device=logits.device).expand(*logits.shape[:-1], k)
    return logits.gather(-1, idx), idx


def f32_dispatch(x, router, cfg_, gb, gs, cap):
    # the same dispatch with the router's matmul in float32
    real = torch.matmul
    def mm(a, b):
        if b.shape == router.shape and b.dtype == x.dtype:
            return real(a.float(), router.float())
        return real(a, b)
    torch.matmul = mm
    try:
        return real_dispatch(x, router, cfg_, gb, gs, cap)
    finally:
        torch.matmul = real


def hold(name):
    done, eng = cs.lm_recorded(cfg, params, 4, 4, dev)
    rows = {u: cs.lm_one_slot(cfg, eng.params, r, dev) for u, r in done.items()}
    rels = sorted(cs._rms_rel(ia, inc) for u, r in done.items()
                  for ia, (lg, inc) in zip(r.increments, rows[u]))
    dl = max(float((a - lg).abs().max()) for u, r in done.items()
             for a, (lg, _) in zip(r.logits, rows[u]))
    flips = sum(int(torch.argmax(a)) != int(torch.argmax(lg)) for u, r in done.items()
                for a, (lg, _) in zip(r.logits, rows[u]))
    n = len(rels)
    print(f"  {name}: {n} steps; increment RMS diff of its RMS: max {rels[-1]:.4g}, "
          f"median {rels[n // 2]:.4g}, {sum(r > 0.1 for r in rels)} steps over 0.1, "
          f"{sum(r == 0 for r in rels)} exactly 0; max |dlogit| {dl:.4g}; {flips} argmax "
          f"differences", flush=True)
    del done, eng, rows
    if not SMOKE:
        cs._free()


for name, tk, disp in (("(a) as routed, ties counted", counting_top_k, real_dispatch),
                       ("(b) routing fixed to experts 0 and 1", fixed_top_k, real_dispatch),
                       ("(c) router logits in float32", real_top_k, f32_dispatch)):
    moe.top_k, moe._dispatch = tk, disp
    t0 = time.perf_counter()
    TIES.update(tokens=0, within_ulp=0, exact=0)
    hold(f"grok 2 layers bf16, capacity factor {ek}, {name}")
    if tk is counting_top_k:
        print(f"  router: {TIES['tokens']} token routings (batched and one-slot runs), "
              f"{TIES['within_ulp']} with the k-th and (k+1)-th logits within one bf16 ulp, "
              f"{TIES['exact']} exactly tied", flush=True)
    print(f"  [{time.perf_counter() - t0:.1f} s]", flush=True)
moe.top_k, moe._dispatch = real_top_k, real_dispatch
