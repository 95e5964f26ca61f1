#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run on error:

1. device   require CUDA; print the card's name and power limit.
2. build    compile every CUDA kernel of the serving path (nvcc, sm_90a).
3. kernels  hold each kernel against its plain PyTorch version on the card,
            bit for bit (integer outputs, tolerance 0), at the serving path's
            shapes and a few more; time kernel and plain version.
4. serve    the launcher at full width (625 sites, 64 slots, 512 requests,
            4 STDP warm-up waves, impl=fused) on the card, with every kernel
            launch counted; then the same launcher on the CPU (plain path,
            same seeds) must give the same warmed weights, vote table and
            class id for every request. Then the same requests served again
            in steady state, and once under torch.profiler.
5. report   one JSON line per run with every kernel's numbers, the card's
            nvidia-smi line, then the result line.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs.tnn_mnist import (  # noqa: E402
    deep_config, launcher_network_config, network_config,
)
from repro_torch.core.column import (  # noqa: E402
    ColumnConfig, body_potential, crossing_time,
)
from repro_torch.core.layer import LayerConfig  # noqa: E402
from repro_torch.core.network import NetworkConfig  # noqa: E402
from repro_torch.core.temporal import WaveSpec  # noqa: E402
from repro_torch.data.mnist_like import digits  # noqa: E402
from repro_torch.kernels import _build, tnn_wave  # noqa: E402
from repro_torch.kernels.padding import network_plan  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve.tnn_engine import ClassifyRequest, TNNEngine  # noqa: E402

# H100 SXM published peaks (NVIDIA's data sheet): HBM bytes/s, and the float32
# rate outside the tensor cores, used for the kernel's 32-bit integer
# arithmetic (int32 is not faster, so this keeps the bound a lower bound).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

SERVE_ARGS = ["--arch", "tnn-mnist", "--sites", "625", "--slots", "64",
              "--requests", "512", "--train-waves", "4", "--impl", "fused"]


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def _rand_inputs(cfg: NetworkConfig, B: int, seed: int, dev: torch.device):
    """Seeded volleys, weights and STDP uniforms, drawn on the host."""
    g = torch.Generator().manual_seed(seed)
    T = cfg.layers[0].column.wave.T
    C, p1 = cfg.layers[0].n_cols, cfg.layers[0].column.p
    x = torch.randint(0, T + 1, (B, C, p1), generator=g, dtype=torch.uint8)
    ws = [torch.randint(0, l.column.wave.w_max + 1,
                        (l.n_cols, l.column.p, l.column.q), generator=g,
                        dtype=torch.int8) for l in cfg.layers]
    us = [torch.rand((l.n_cols, 2, B, l.column.p, l.column.q), generator=g)
          for l in cfg.layers]
    return (x.to(dev), [w.to(dev) for w in ws], [u.to(dev) for u in us])


def _max_err(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def check_case(name, cfg, B, seed, dev):
    """Kernel vs plain version on the card, forward and learn, bit for bit;
    returns the largest absolute difference (0, or it raises)."""
    x, ws, us = _rand_inputs(cfg, B, seed, dev)
    plan = network_plan(cfg, B)
    pairs = [(u[:, 0], u[:, 1]) for u in us]
    zk = tnn_wave.wave_forward(x, ws, plan=plan)
    zp = tnn_wave.wave_forward_plain(x, ws, plan=plan)
    (zlk, nk) = tnn_wave.wave_train(x, ws, pairs, plan=plan)
    (zlp, np_) = tnn_wave.wave_train_plain(x, ws, pairs, plan=plan)
    torch.cuda.synchronize()
    err = 0
    for a, b in list(zip(zk, zp)) + list(zip(zlk, zlp)) + list(zip(nk, np_)):
        if a.shape != b.shape:
            raise AssertionError(f"{name}: shape {tuple(a.shape)} != {tuple(b.shape)}")
        err = max(err, _max_err(a, b))
    spikes = [int((z < plan.T).sum()) for z in zk]
    nets = [int(n.abs().sum()) for n in nk]
    print(f"  {name}: B={B} thetas={plan.thetas} spikes/layer={spikes} "
          f"|net|/layer={nets} max_abs_err={err}", flush=True)
    if err:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    return err


def time_cuda(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events, after
    a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def forward_work(cfg, x, ws, plan):
    """(bytes, operations) one forward wave needs: every input read once and
    every output written once; the direct ramp form's min + add per synapse
    for each tick up to the neuron's crossing (all T ticks when it never
    crosses), counted from this run's data."""
    B, C, p1 = x.shape
    spec = cfg.layers[0].column.wave
    nbytes = x.numel() + sum(w.numel() for w in ws) + sum(B * C * q for q in plan.qs)
    ops, v = 0, x
    for w, theta, p in zip(ws, plan.thetas, plan.ps):
        z_pre = crossing_time(body_potential(v.transpose(0, 1), w, spec), theta, spec)
        ticks = torch.where(z_pre < spec.T, z_pre.to(torch.int64) + 1, spec.T)
        ops += 2 * p * int(ticks.sum())
        v = tnn_wave._layer_plain(v, w, theta, spec)
    return nbytes, ops


def bound(nbytes: int, ops: int):
    """(bound ms, what bounds it, bytes-only ms, operations-only ms)."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / SCALAR_OPS_PER_S
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            t_bytes, t_ops)


def measure(cfg, dev):
    """Kernel and plain ms at the serving shapes: forward at B=64 and learn
    at B=16, full width, the served thresholds."""
    out = {}
    for half, B, iters in (("forward", 64, 200), ("learn", 16, 100)):
        x, ws, us = _rand_inputs(cfg, B, seed=11, dev=dev)
        plan = network_plan(cfg, B)
        pairs = [(u[:, 0], u[:, 1]) for u in us]
        if half == "forward":
            k = lambda: tnn_wave.wave_forward(x, ws, plan=plan)  # noqa: E731
            p = lambda: tnn_wave.wave_forward_plain(x, ws, plan=plan)  # noqa: E731
        else:
            k = lambda: tnn_wave.wave_train(x, ws, pairs, plan=plan)  # noqa: E731
            p = lambda: tnn_wave.wave_train_plain(x, ws, pairs, plan=plan)  # noqa: E731
        plain_a = time_cuda(p, 5)  # in turns: plain, kernel, kernel, plain
        ms_a = time_cuda(k, iters)
        ms_b = time_cuda(k, iters)
        plain_b = time_cuda(p, 5)
        nbytes, ops = forward_work(cfg, x, ws, plan)
        if half == "learn":
            pq = sum(p_ * q_ for p_, q_ in zip(plan.ps, plan.qs))
            C = plan.n_cols
            nbytes += 8 * C * B * pq + 4 * C * pq  # uniforms in, nets out
            ops += 2 * C * B * pq                  # the two Bernoulli compares
        bms, by, bytes_ms, ops_ms = bound(nbytes, ops)
        out[half] = dict(B=B, ms=min(ms_a, ms_b), plain_ms=min(plain_a, plain_b),
                         bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops,
                         bytes_ms=bytes_ms, ops_ms=ops_ms)
        print(f"  {half} B={B}: kernel {ms_a:.4f}/{ms_b:.4f} ms, plain "
              f"{plain_a:.3f}/{plain_b:.3f} ms, bound {bms:.5f} ms ({by}; "
              f"{nbytes} bytes = {bytes_ms:.6f} ms, {ops} ops = "
              f"{ops_ms:.6f} ms)", flush=True)
    return out


def profile_serve(rep, dev, repeats: int = 5):
    """Steady-state serving with the launcher's warmed weights: the same 512
    requests served ``repeats`` times untraced (images/s, p50/p95 of each),
    then once under torch.profiler for where the time goes: device busy
    time by kernel, host time by op, and the device's idle share of the
    wall time. Every pass must give the launcher's class ids."""
    cfg = launcher_network_config(625, impl="fused")
    eng = TNNEngine(cfg, rep.params, n_slots=64, impl="fused", device=dev)
    eng.fit(*digits(256, seed=1))
    imgs = digits(512, seed=2)[0]

    def run():
        eng.reset()
        for uid in range(512):
            eng.submit(ClassifyRequest(uid=uid, image=imgs[uid]))
        t0 = time.perf_counter()
        done = eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if {u: r.result for u, r in done.items()} != rep.results:
            raise AssertionError("steady-state serve changed a class id")
        return wall, eng.stats()

    run()  # warm-up pass
    steady = [run() for _ in range(repeats)]
    for wall, st in steady:
        print(f"  steady: {st.images_per_s:.1f} images/s, {st.waves_per_s:.1f} "
              f"waves/s, p50 {st.p50_ms:.3f} ms, p95 {st.p95_ms:.3f} ms", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall, st = run()
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"  traced pass: wall {1e3 * wall:.3f} ms for {st.waves} waves; device "
          f"busy {busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / (1e6 * wall):.3f}", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    device {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:70]}")
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"    host   {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:70]}")
    return {"steady_images_per_s": [s.images_per_s for _, s in steady],
            "steady_p50_ms": [s.p50_ms for _, s in steady],
            "steady_p95_ms": [s.p95_ms for _, s in steady],
            "traced_wall_ms": 1e3 * wall, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / (1e6 * wall)}


def caps_config(C: int) -> NetworkConfig:
    """The largest layer-1 the fused plan takes (p1=512, q=128) and a
    128-wide second layer: exercises shared memory above 48 KB."""
    wave = WaveSpec()
    l1 = LayerConfig(C, ColumnConfig(p=512, q=128, theta=300, wave=wave, impl="fused"))
    l2 = LayerConfig(C, ColumnConfig(p=128, q=128, theta=3, wave=wave, impl="fused"))
    return NetworkConfig(layers=(l1, l2))


def main() -> int:
    t_start = time.perf_counter()
    phase("device")
    if not torch.cuda.is_available():
        print("CUDA is not available: this script needs one CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi_line = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"  {kind}; nvidia-smi: {smi_line}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    phase("build")
    t0 = time.perf_counter()
    tnn_wave.build()
    print(f"  tnn_wave built/loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log("tnn_wave").splitlines():
        if "registers" in line or "smem" in line or line.startswith("["):
            print(f"  {line.strip()}")

    phase("kernels vs plain (bit for bit)")
    full_hi = network_config(625, 24, 8, impl="fused")    # the served thresholds
    full_lo = network_config(625, 12, 3, impl="fused")    # both layers fire
    deep = deep_config(625, widths=(12, 12, 10), thetas=(12, 3, 1), impl="fused")
    err = 0
    for name, cfg, B, seed in (
            ("full theta=(24,8) serve", full_hi, 64, 1),
            ("full theta=(24,8) learn", full_hi, 16, 2),
            ("full theta=(12,3) serve", full_lo, 64, 3),
            ("full theta=(12,3) learn", full_lo, 16, 4),
            ("full ragged", full_lo, 13, 5),
            ("full multi-chunk", full_lo, 300, 6),
            ("deep depth-3", deep, 64, 7),
            ("deep depth-3 learn", deep, 16, 8),
            ("caps p1=512 q=128", caps_config(132), 40, 9)):
        err = max(err, check_case(name, cfg, B, seed, dev))
    timing = measure(full_hi, dev)

    phase("serve (main path: launcher on the card, full width)")
    tnn_wave.LAUNCHES.reset()
    t0 = time.perf_counter()
    rep = launch_serve.main(SERVE_ARGS + ["--device", "cuda"])
    torch.cuda.synchronize()
    launches = tnn_wave.LAUNCHES.forward, tnn_wave.LAUNCHES.learn
    wall = time.perf_counter() - t0
    st = rep.stats
    print(f"  launcher wall {wall:.2f} s; tnn_wave launches: forward "
          f"{launches[0]}, learn {launches[1]}", flush=True)
    train_waves = 4
    if launches[1] < train_waves:
        raise AssertionError(f"{launches[1]} learn launches for {train_waves} warm-up waves")
    if launches[0] < st.waves:
        raise AssertionError(f"{launches[0]} forward launches for {st.waves} served waves")
    if st.requests != 512 or len(rep.results) != 512:
        raise AssertionError(f"served {st.requests} of 512 requests")
    if not all(0 <= c < 10 for c in rep.results.values()):
        raise AssertionError("class id out of range")
    if not torch.isfinite(rep.vote_table).all():
        raise AssertionError("vote table is not finite")

    phase("serve on the CPU (plain path, same seeds)")
    t0 = time.perf_counter()
    ref = launch_serve.main(SERVE_ARGS + ["--device", "cpu"])
    print(f"  cpu launcher wall {time.perf_counter() - t0:.2f} s", flush=True)
    for l, (a, b) in enumerate(zip(rep.params, ref.params)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"warmed layer-{l} weights differ from the CPU run")
    if not torch.equal(rep.vote_table.cpu(), ref.vote_table):
        raise AssertionError("vote table differs from the CPU run")
    diff = [u for u in ref.results if rep.results[u] != ref.results[u]]
    if diff:
        raise AssertionError(f"{len(diff)} class ids differ from the CPU run, "
                             f"first uid {diff[0]}")
    print(f"  card == cpu: warmed weights, vote table and all "
          f"{len(ref.results)} class ids; layer spikes in the first served "
          f"wave {rep.served_spikes} (the paper thresholds leave layer 2 "
          f"silent at 625 sites, as in the reference)", flush=True)

    phase("serve, steady state and traced")
    prof = profile_serve(rep, dev)

    phase("report")
    src = "src/repro_torch/kernels/csrc/tnn_wave.cu"
    replaces = "src/repro/kernels/tnn_wave.py:70"
    kernels = []
    for half, n in (("forward", launches[0]), ("learn", launches[1])):
        t = timing[half]
        kernels.append({
            "name": f"tnn_wave[{half}]", "route": "cuda", "source": src,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    print(json.dumps({
        "serve": {"waves": st.waves, "requests": st.requests,
                  "waves_per_s": st.waves_per_s, "images_per_s": st.images_per_s,
                  "p50_ms": st.p50_ms, "p95_ms": st.p95_ms,
                  "occupancy": st.occupancy, "accuracy": rep.accuracy,
                  "warmup_spikes": rep.warmup_spikes,
                  "served_spikes": rep.served_spikes, **prof},
        "shapes": {h: {k: t[k] for k in ("B", "bytes", "ops", "bytes_ms", "ops_ms")}
                   for h, t in timing.items()},
        "seconds": time.perf_counter() - t_start,
    }))
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
