"""chip_smoke.py's meshed serve holds alone: the six non-dense families'
smoke serve at 2x2 and 1x4 (4 gloo ranks sharing the card) held to one
process on the card, and the collective probe's whisper-tiny and
internvl2-76b prefill cells at 2x2, with their seconds and ms.

``python3 probes/lm_mesh_serve.py`` (a card; about a minute)."""
import os, subprocess, sys, time
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT); sys.path.insert(0, os.path.join(ROOT, "src"))
import torch
import chip_smoke as CS

REF = os.path.join(ROOT, "build", "lm_mesh_serve_ref.pt")   # .gitignore lists build/


def ranks():
    ref = torch.load(REF, weights_only=False)
    out = {}
    for d, m in CS.LM_MESH_FACTORS:
        mesh = CS.make_mesh_2d(d, m, device="cuda", backend="gloo")
        t0 = time.perf_counter()
        res = {"family_serve": CS._lm_mesh_family_serve(mesh, ref, mesh.is_main)}
        res["fs_s"] = time.perf_counter() - t0
        if (d, m) == (2, 2):
            t0 = time.perf_counter()
            res["probe_serve"] = CS._lm_mesh_probe_serve(mesh)
            res["probe_s"] = time.perf_counter() - t0
        out[f"{d}x{m}"] = res
    return out


if __name__ == "__main__":
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ref = CS.lm_mesh_family_serve_reference(dev)
    print("one-process reference s", round(time.perf_counter() - t0, 1), flush=True)
    torch.save(ref, REF)
    t0 = time.perf_counter()
    res = CS.spawn_ranks(ranks, 4, work_dir=os.path.join(ROOT, "build", "lm_mesh_serve_ranks"),
                         device="cuda", backend="gloo", timeout_s=600)
    print("ranks s", round(time.perf_counter() - t0, 1), flush=True)
    for f in ("2x2", "1x4"):
        print(f, "family serve s", round(res[0][f]["fs_s"], 1))
        for arch, r in res[0][f]["family_serve"].items():
            one = ref[f"{arch}@{f}"]
            print(" ", arch, [f"{e:.2g}" for e in r["logit_err_of_max"]], "ties", r["near_ties"],
                  f"cache {r['cache_err_of_max']:.3g}", r["worst_cache_leaf"],
                  f"prefill {r['prefill_ms']:.1f} ms ticks {[round(x, 1) for x in r['decode_tick_ms']]}",
                  f"one process {one['prefill_ms']:.1f} / {[round(x, 1) for x in one['decode_tick_ms']]}",
                  f"{r['seconds']:.1f} s", flush=True)
    print("probe serve s", round(res[0]["2x2"]["probe_s"], 1))
    for arch, lines in res[0]["2x2"]["probe_serve"].items():
        print(arch, lines[0])
    print("OK")
