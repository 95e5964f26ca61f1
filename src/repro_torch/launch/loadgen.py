"""Load generation for the port's TNN serving engine, as the reference's
``tools/loadgen.py``.

* **closed loop**: the whole request set is enqueued up front and the
  engine drains it (throughput under full backlog).
* **open loop**: requests arrive on a seeded Poisson clock for a fixed
  time and the engine serves them as they land, so p50/p95 include real
  queueing.

Both return the engine's ``ServeStats``. With ``--labelled`` (implied by
``--online-stdp``) every request's label is known, and :func:`ab_accuracy`
splits accuracy by the published version each request was classified
under, over a window of the latest retirements: a hot swap shows as the
accuracy of version v against v+1 on the same recent traffic.

    PYTHONPATH=src python -m repro_torch.launch.loadgen --mode closed \\
        --requests 64 --sites 16 --slots 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.loadgen --mode open \\
        --rate 200 --duration 2.0 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.loadgen --mode closed \\
        --requests 96 --online-stdp --swap-every 4 --window 48 --device cpu

Without ``--device cpu`` it runs on the card.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch import random as _random
from repro_torch.configs.tnn_mnist import (
    crop_field, launcher_network_config, network_config,
)
from repro_torch.core.network import init_network
from repro_torch.data.mnist_like import digits
from repro_torch.serve.tnn_engine import ClassifyRequest, ServeStats, TNNEngine


def poisson_arrivals(rate_hz: float, duration_s: float,
                     seed: int = 0) -> np.ndarray:
    """Sorted arrival times (seconds) of a Poisson process: exponential
    gaps at ``rate_hz``, truncated at ``duration_s``; the same draws as the
    reference's, so the same times for a seed."""
    if rate_hz <= 0 or duration_s <= 0:
        raise ValueError(f"need rate_hz > 0 and duration_s > 0, got "
                         f"rate_hz={rate_hz}, duration_s={duration_s}")
    rng = np.random.default_rng(seed)
    ts: list = []
    t = 0.0
    while t < duration_s:
        gaps = rng.exponential(1.0 / rate_hz, size=max(int(rate_hz), 16))
        for g in gaps:
            t += g
            if t >= duration_s:
                break
            ts.append(t)
    return np.asarray(ts, np.float64)


def build_engine(sites: int = 16, slots: int = 8, impl: str = "fused",
                 depth: int = 2, seed: int = 0, online_stdp: bool = False,
                 swap_every: int = 0, thetas: Optional[Tuple[int, int]] = None,
                 device="cuda") -> TNNEngine:
    """A ready-to-serve engine on the launcher's convention: the network of
    ``launcher_network_config`` (or the 2-layer prototype at ``thetas``),
    weights from ``PRNGKey(seed)``, the vote table fit on ``digits(max(64,
    4 * slots), seed=1)``."""
    if thetas is None:
        cfg = launcher_network_config(sites, depth=depth, impl=impl)
    else:
        cfg = network_config(sites, *thetas, impl=impl)
    eng = TNNEngine(cfg, init_network(_random.PRNGKey(seed), cfg, device),
                    n_slots=slots, impl=impl, device=device,
                    online_stdp=online_stdp, swap_every=swap_every, seed=seed)
    imgs, labs = digits(max(64, 4 * slots), seed=1)
    eng.fit(crop_field(imgs, sites), labs)
    return eng


def labelled_images(sites: int, n: int, seed: int = 2):
    """``(images, labels)``: held-out digits with their labels. Request
    ``uid`` carries image (and label) ``uid % n``, which is how
    :func:`ab_accuracy` finds its truth."""
    imgs, labs = digits(n, seed=seed)
    return crop_field(imgs, sites), np.asarray(labs)


def ab_accuracy(done: Dict[int, ClassifyRequest], labels: np.ndarray,
                window: int = 0) -> Dict[int, Tuple[float, int]]:
    """``{version: (accuracy, n)}`` over the retired requests, sorted by
    version; a request's truth is ``labels[uid % len(labels)]``. ``window >
    0`` keeps only the last ``window`` retirements (by completion time,
    then uid)."""
    reqs = sorted(done.values(), key=lambda r: (r.t_done, r.uid))
    if window:
        reqs = reqs[-window:]
    hits: dict = {}
    for r in reqs:
        ok = int(r.result == labels[r.uid % len(labels)])
        n_ok, n = hits.get(r.version, (0, 0))
        hits[r.version] = (n_ok + ok, n + 1)
    return {v: (n_ok / n, n) for v, (n_ok, n) in sorted(hits.items())}


def run_closed_loop(eng: TNNEngine, images: np.ndarray, n_requests: int,
                    pipelined: bool = True) -> ServeStats:
    """Enqueue ``n_requests`` up front, drain, return the engine stats."""
    for uid in range(n_requests):
        eng.submit(ClassifyRequest(uid=uid, image=images[uid % len(images)]))
    eng.run_until_done(pipelined=pipelined)
    return eng.stats()


def run_open_loop(eng: TNNEngine, images: np.ndarray,
                  arrivals: np.ndarray) -> ServeStats:
    """Submit on the arrival clock and serve pipelined as requests land:
    with nothing pending the loop sleeps to the next arrival, else it polls
    (one dispatch a poll, so admission interleaves with service)."""
    t0 = time.perf_counter()
    i, n = 0, len(arrivals)
    while i < n or eng.pending:
        now = time.perf_counter() - t0
        while i < n and arrivals[i] <= now:
            eng.submit(ClassifyRequest(uid=i, image=images[i % len(images)]))
            i += 1
        if eng.pending:
            eng.poll()
        elif i < n:
            time.sleep(max(arrivals[i] - now, 0.0))
    return eng.stats()


def fmt(st: ServeStats) -> str:
    return (f"{st.requests} requests / {st.waves} waves in {st.wall_s:.3f}s: "
            f"{st.waves_per_s:.1f} waves/s, {st.images_per_s:.1f} images/s, "
            f"p50 {st.p50_ms:.3f} ms, p95 {st.p95_ms:.3f} ms, "
            f"occupancy {st.occupancy:.0%}")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("closed", "open"), default="closed")
    ap.add_argument("--requests", type=int, default=64,
                    help="closed-loop request count")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="open-loop Poisson arrival rate (requests/s)")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="open-loop arrival window (s)")
    ap.add_argument("--sites", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--impl", default="fused",
                    choices=("direct", "matmul", "pallas", "fused"))
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lockstep", action="store_true",
                    help="closed loop only: the blocking one-wave loop")
    ap.add_argument("--labelled", action="store_true",
                    help="labelled traffic: report per-version accuracy "
                         "after the run (implied by --online-stdp)")
    ap.add_argument("--online-stdp", action="store_true",
                    help="learn while serving, hot-swapped every "
                         "--swap-every learning waves")
    ap.add_argument("--swap-every", type=int, default=16,
                    help="learning waves between hot swaps with "
                         "--online-stdp (0 = never automatically)")
    ap.add_argument("--window", type=int, default=64,
                    help="A/B window: per-version accuracy over the last N "
                         "retired requests (0 = all)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    labelled = args.labelled or args.online_stdp
    eng = build_engine(sites=args.sites, slots=args.slots, impl=args.impl,
                       depth=args.depth, seed=args.seed,
                       online_stdp=args.online_stdp,
                       swap_every=args.swap_every if args.online_stdp else 0,
                       device=args.device)
    imgs, labs = labelled_images(args.sites, max(args.requests, 64))
    run_closed_loop(eng, imgs, args.slots)  # warm-up: kernels built, caches hot
    eng.reset()
    if args.mode == "closed":
        st = run_closed_loop(eng, imgs, args.requests, pipelined=not args.lockstep)
        mode = "lock-step" if args.lockstep else "pipelined"
        print(f"[loadgen closed/{mode}] {fmt(st)}")
    else:
        arrivals = poisson_arrivals(args.rate, args.duration, seed=args.seed)
        st = run_open_loop(eng, imgs, arrivals)
        print(f"[loadgen open @ {args.rate:.0f} requests/s x {args.duration:.1f}s "
              f"({len(arrivals)} arrivals)] {fmt(st)}")
    if args.online_stdp:
        print(f"[loadgen online-stdp] {eng.swaps} hot swap(s), now serving "
              f"v{eng.version}")
    ab = ab_accuracy(eng.done, labs, window=args.window) if labelled else {}
    win = args.window or len(eng.done)
    for ver, (acc, n) in ab.items():
        print(f"[loadgen ab] v{ver}: accuracy {acc:.1%} ({n} of last {win} requests)")
    return {"stats": st, "ab": ab, "engine": eng}


if __name__ == "__main__":
    main()
