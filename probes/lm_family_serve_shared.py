"""mesh_cards.py's family serve holds with 4 gloo ranks SHARING one card:
each arch's one-process reference on rank 0 (``mesh_cards.family_reference``),
then its serve steps at 2x2 and 1x4 held to it (``mesh_cards.family_serve``:
logits and every cache leaf after the last tick within 1e-4 of the largest,
greedy tokens outside near ties). The placements and DTensor's planning are
the NCCL runs' (only the collectives differ), so a torch DTensor site that
full width reaches shows here on one card.

``python3 probes/lm_family_serve_shared.py cuda [ARCH ...]`` (full width;
xlstm-125m by default) or ``... cpu [ARCH ...]`` (the smoke configs)."""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def ranks(archs, device: str):
    import mesh_cards as MC
    from repro_torch.launch.mesh import make_mesh_2d

    meshes = {f"{d}x{m}": make_mesh_2d(d, m, device=device, backend="gloo")
              for d, m in MC.FAMILY_SERVE_MESHES}
    first = next(iter(meshes.values()))
    smoke = device == "cpu"
    out = {}
    for arch in archs:
        ref = MC.family_reference(arch, smoke, first.device) if first.is_main else None
        view = MC.family_ref_on_ranks(ref, first.is_main, first.device)
        out[arch] = {f: MC.family_serve(arch, smoke, mesh, view) for f, mesh in meshes.items()}
        del ref, view
    return out


if __name__ == "__main__":
    from repro_torch.launch.mesh import spawn_ranks

    device = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    archs = sys.argv[2:] or ["xlstm-125m"]
    res = spawn_ranks(ranks, 4, work_dir=os.path.join(ROOT, "build", "probe_family_serve"),
                      device=device, backend="gloo", threads=2 if device == "cpu" else 0,
                      timeout_s=900, args=(archs, device))
    for arch, by_mesh in res[0].items():
        for f, r in by_mesh.items():
            print(f"{arch} serve at {f}, 4 gloo ranks sharing one {device} device: logits err/max "
                  f"{[f'{e:.2g}' for e in r['logit_err_of_max']]}, near ties {r['near_ties']}, "
                  f"cache within {r['cache_err_of_max']:.3g} of the leaf's largest, prefill "
                  f"{r['prefill_ms']:.1f} ms, ticks {[round(v, 1) for v in r['decode_tick_ms']]} ms",
                  flush=True)
    print(json.dumps(res[0], default=str))
