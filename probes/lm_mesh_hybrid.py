"""chip_smoke.py's meshed train holds alone: the five non-dense families'
smoke train steps at 2x2 (4 gloo ranks sharing the card) held to one process
on the card under the set-aside rule, the AdamW update fed the one-process
step-2 inputs, zamba2-7b at full width cut to one unit and the tail at 2x2,
and the meshed zamba2-7b launcher, with their seconds and ms.

``python3 probes/lm_mesh_hybrid.py`` (a card; a few minutes)."""
import os, subprocess, sys, time
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT); sys.path.insert(0, os.path.join(ROOT, "src"))
import torch
import chip_smoke as CS

REF = os.path.join(CS.LM_MESH_DIR, "ref.pt")


def ranks():
    ref = torch.load(REF, mmap=True, weights_only=False)
    mesh = CS.make_mesh_2d(2, 2, device="cuda", backend="gloo")
    out = {}
    t0 = time.perf_counter()
    out["families"] = CS._lm_mesh_families(mesh, ref["families"])
    out["families_s"] = time.perf_counter() - t0
    out["hybrid"] = CS._lm_mesh_hybrid(mesh, ref["hybrid"], mesh.is_main)
    out["launch"] = CS._lm_mesh_launch_hybrid(mesh.is_main)
    return out


if __name__ == "__main__":
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    print(subprocess.run(["df", "-h", ROOT, "/dev/shm", "/tmp"], capture_output=True,
                         text=True).stdout, flush=True)
    dev = torch.device("cuda:0")
    os.makedirs(CS.LM_MESH_DIR, exist_ok=True)
    t0 = time.perf_counter()
    fam = CS.lm_mesh_family_reference(dev)
    print("families one process s", round(time.perf_counter() - t0, 1), flush=True)
    t0 = time.perf_counter()
    hy = CS.lm_mesh_hybrid_reference(dev)
    print("hybrid one process s", round(time.perf_counter() - t0, 1), hy["params"], "params, step ms",
          [round(x, 1) for x in hy["step_ms"]], "peak GB", round(hy["peak_bytes"] / 1e9, 2),
          "draw s", round(hy["draw_s"], 1), "set aside",
          sum(r["aside"] for r in hy["rule"].values()), flush=True)
    t0 = time.perf_counter()
    torch.save({"families": fam, "hybrid": hy}, REF)
    print("ref.pt written s", round(time.perf_counter() - t0, 1), "bytes", os.path.getsize(REF),
          flush=True)
    del fam, hy
    t0 = time.perf_counter()
    res = CS.spawn_ranks(ranks, 4, work_dir=os.path.join(CS.LM_MESH_DIR, "ranks"),
                         device="cuda", backend="gloo", timeout_s=800)
    print("ranks s", round(time.perf_counter() - t0, 1), "families s",
          round(res[0]["families_s"], 1), flush=True)
    for arch, f in res[0]["families"].items():
        print(" ", arch, {k: f[k] for k in (
            "grad_err_of_max", "worst_grad_leaf", "param_max_diff_in_lr",
            "param_rms_diff_of_move", "worst_rms_leaf", "set_aside", "set_aside_max_lr",
            "forced_ulps", "forced_norm_equal", "seconds")},
            "rank 0 step ms", [round(x, 1) for x in f["step_ms"]], flush=True)
    h = res[0]["hybrid"]
    print("hybrid 2x2", {k: h[k] for k in ("param_max_diff_in_lr", "param_rms_diff_of_move",
                                            "worst_rms_leaf", "set_aside", "set_aside_max_lr",
                                            "own_grad_norm_rel", "grad_err_of_max",
                                            "worst_grad_leaf", "forced_grad_norm", "forced_ulps",
                                            "forced_norm_equal", "trace", "seconds")},
          "step ms/rank", [[round(x, 1) for x in r["hybrid"]["step_ms"]] for r in res],
          "peak GB/rank", [round(r["hybrid"]["peak_bytes"] / 1e9, 2) for r in res],
          "draw s/rank", [round(r["hybrid"]["draw_s"], 1) for r in res], flush=True)
    print("launch", res[0]["launch"])
    import shutil
    shutil.rmtree(CS.LM_MESH_DIR, ignore_errors=True)
    print("OK")
