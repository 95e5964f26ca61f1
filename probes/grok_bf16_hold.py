"""grok-1-314b at 2 layers, bf16, served through the launcher at 4 slots;
the same requests recorded and held to one-slot bf16 runs with the
capacity factor at E/k (no token can drop) and at the config's own (drops
possible); plus the bf16 residual's ulp beside the increment's RMS.

On the card (about 80 s, 64 GiB): ``python3 probes/grok_bf16_hold.py``."""
import dataclasses, os, sys, time
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src")); sys.path.insert(0, ROOT)
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from repro_torch.launch import serve as launch_serve

dev = torch.device("cuda")
from repro_torch.kernels import autotune
print(autotune.smi_line(), flush=True)
grok = cs.get_lm_config("grok-1-314b")
ek = grok.n_experts / grok.experts_per_token
cut = dataclasses.replace(grok, n_layers=2, layout_repeat=2, moe_capacity_factor=ek)
print(f"grok: E={grok.n_experts} k={grok.experts_per_token} own capacity factor "
      f"{grok.moe_capacity_factor}, E/k {ek}", flush=True)
four = ["--requests", "4", "--slots", "4", "--max-new", str(cs.LM_MAX_NEW),
        "--max-len", str(cs.LM_MAX_LEN)]
t0 = time.perf_counter()
args = launch_serve.parse_args(["--arch", "grok-1-314b", *four])
rep = launch_serve.serve_lm(args, cfg=cut)
rep.engine = None
cs._free()
print(f"served in {time.perf_counter() - t0:.1f} s; params dtype "
      f"{next(iter(cs.lm_tree_flatten(rep.params)))[1].dtype}", flush=True)
tokens = {u: list(r.out_tokens) for u, r in rep.done.items()}
for cf in (ek, grok.moe_capacity_factor):
    c = dataclasses.replace(rep.cfg, moe_capacity_factor=cf)
    done, eng = cs.lm_recorded(c, rep.params, 4, 4, dev)
    same = {u: r.out_tokens for u, r in done.items()} == tokens
    print(f"cf {cf}: recorded tokens equal the launcher's: {same}", flush=True)
    try:
        cs.lm_hold(c, eng.params, done, dev, f"grok 2 layers bf16 hold, capacity factor {cf}")
    except AssertionError as e:
        print(f"  HOLD FAILED: {e}", flush=True)
    # the residual stream's bf16 spacing beside the increment
    incs = torch.stack([i.float() for r in done.values() for i in r.increments])
    print(f"  increment RMS {float(incs.pow(2).mean().sqrt()):.4g}; bf16 ulp at 1.0 "
          f"{2 ** -7:.4g} (the std-1.0 embedding's scale)", flush=True)
    del done, eng
    cs._free()
