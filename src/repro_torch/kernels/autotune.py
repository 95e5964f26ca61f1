"""Launch-geometry autotuner for the Hopper wave kernel, as the reference's
``repro.kernels.autotune`` is for its megakernel.

The forward wave (``csrc/tnn_wave.cu``) has two free launch extents that
``tnn_wave._fill_common`` otherwise fixes by rule: the batch rows one block
takes (the chunk, which sets the grid's second extent) and the warps a block
runs. Neither changes which rows a site's block computes, only how the batch
is dealt out, so a tuned launch is bit-exact with the static one by
construction (the tests and ``chip_smoke.py`` check it anyway). Which is
fastest depends on the geometry (sites, fan-in, depth, batch) and on the
card, so this module measures: for one geometry it times the forward wave on
the card under every candidate and records the winner in a JSON cache keyed
by :func:`repro_torch.kernels.padding.plan_geometry_key`, the reference's key.

The cache is checked in beside this module (``tuned_blocks.json``; the
environment variable ``REPRO_TORCH_TUNED_BLOCKS`` names another file). It
records the card it was tuned on (``nvidia-smi``'s name and power limit)
and, for each geometry, the device ms of a wave, tuned and static.
``network_plan`` consults it on every plan build: an exact geometry match or
nothing; an entry outside the candidate sets is ignored; a geometry without
an entry keeps the static rule. The learning half keeps its rule, as the
reference tunes only the forward. The reference's TPU-tuned
``benchmarks/tuned_blocks.json`` is never read.

The default geometries are the reference's four (16 sites at B = 8 and 625
sites at B = 16, each as the 2-layer prototype and as ``deep_config``'s 3
layers) and three that are this port's additions, because its own main path
launches them: serving at 625 sites with the launcher's default 8 slots and
with the 64 slots that ``chip_smoke.py`` serves, and the forward of the dry
run's ``tnn_infer_64k`` cell at B = 65,536.

CLI (on the card)::

    PYTHONPATH=src python -m repro_torch.kernels.autotune          # tune defaults
    PYTHONPATH=src python -m repro_torch.kernels.autotune --smoke  # 16 sites only
    PYTHONPATH=src python -m repro_torch.kernels.autotune --check  # staleness check

``--check`` exits 1 when the cache lacks an entry for a default geometry.
"""
from __future__ import annotations

import functools
import json
import os
import pathlib
import re
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.tnn_column import CHUNK_TILES, tile_rows, tile_units

WARP_CANDIDATES = (1, 2, 4, 8)

_ENV_CACHE = "REPRO_TORCH_TUNED_BLOCKS"
_KEY_T = re.compile(r"_T(\d+)_B(\d+)_")


def row_candidates(T: int) -> Tuple[int, ...]:
    """Rows per chunk the tuner tries: ``tile_rows(T) * 2**k`` up to the
    static maximum, ``CHUNK_TILES`` m16 tiles."""
    top = max(tile_rows(T), CHUNK_TILES * 16 // T)
    out, r = [], tile_rows(T)
    while r <= top:
        out.append(r)
        r *= 2
    return tuple(out)


def candidates(T: int, batch: int) -> List[Tuple[int, int]]:
    """Every ``(rows, warps)`` pair the tuner times for a batch: rows up to
    the first chunk that holds the whole batch (a larger one is the same
    grid), warps clamped to the chunk's tile units."""
    out = []
    for rows in row_candidates(T):
        out.extend((rows, w) for w in WARP_CANDIDATES
                   if w <= max(1, tile_units(rows, T)))
        if rows >= batch:
            break
    return out


def cache_path() -> pathlib.Path:
    """The tuned cache file: ``$REPRO_TORCH_TUNED_BLOCKS`` when set, else
    ``tuned_blocks.json`` beside this module."""
    env = os.environ.get(_ENV_CACHE)
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parent / "tuned_blocks.json"


@functools.lru_cache(maxsize=4)
def _load(path_str: str, mtime: float) -> Dict:
    del mtime  # cache key only: reload when the file changes
    try:
        with open(path_str) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _load_file() -> Dict:
    path = cache_path()
    try:
        mtime = path.stat().st_mtime
    except OSError:
        return {}
    return _load(str(path), mtime)


def load_cache() -> Dict[str, Dict]:
    """Geometry key -> entry ({} when the cache is absent)."""
    return _load_file().get("geometries", {})


def cache_device() -> Dict[str, str]:
    """The card the cache was tuned on ({} when absent)."""
    return _load_file().get("device", {})


def lookup(key: str) -> Optional[Tuple[int, int]]:
    """Exact-geometry lookup: ``(rows, warps)`` or ``None`` (the static
    rule). An entry outside the candidate sets of its key's ``T`` is ignored
    rather than trusted: a hand-edited cache cannot push the launch outside
    the kernel's contract."""
    e = load_cache().get(key)
    m = _KEY_T.search(key)
    if not isinstance(e, dict) or m is None:
        return None
    rows, warps = e.get("rows"), e.get("warps")
    if rows not in row_candidates(int(m.group(1))) or warps not in WARP_CANDIDATES:
        return None
    return int(rows), int(warps)


def smi_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_ms() -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def device_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn`` over ``iters`` back-to-back launches,
    by CUDA events. The stream is first held by a sleep kernel longer than
    the host takes to enqueue them, so the events see the card's time and
    not the wrapper's."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - h0) * 1e3
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * (host_ms + 1.0) * _sleep_cycles_per_ms()))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def tune_geometry(cfg, batch: int, n: int = 5, verbose: bool = False) -> Dict:
    """Time every candidate of one fused-capable geometry on the card and
    return the winning entry (not yet written to the cache): the best of
    ``n`` timings each, device ms a wave, beside the static rule's. Every
    candidate's output must equal the static launch's. The card only: without
    one it raises."""
    from repro_torch import random as _random
    from repro_torch.core.network import init_network, with_impl
    from repro_torch.device import resolve_device
    from repro_torch.kernels import padding as _kpad
    from repro_torch.kernels import tnn_wave as _ktw

    dev = resolve_device("cuda")
    cfg = with_impl(cfg, "fused")
    params = tuple(init_network(_random.PRNGKey(0), cfg, dev))
    first = cfg.layers[0]
    T = first.column.wave.T
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randint(0, T + 1, (batch, first.n_cols, first.column.p),
                      generator=g, device=dev, dtype=torch.uint8)
    static_plan = _kpad.network_plan(cfg, batch, launch=_kpad.STATIC)
    want = _ktw.wave_forward(x, params, plan=static_plan)

    def wave(plan):
        return lambda: _ktw.wave_forward(x, params, plan=plan)

    one = device_ms(wave(static_plan), 1)
    iters = max(5, min(200, int(2.0 / max(one, 1e-3))))

    def best(plan):
        return min(device_ms(wave(plan), iters) for _ in range(n))

    static_ms = best(static_plan)
    results = []
    for rows, warps in candidates(T, batch):
        plan = _kpad.network_plan(cfg, batch, launch=(rows, warps))
        got = _ktw.wave_forward(x, params, plan=plan)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"rows={rows} warps={warps} differs from the "
                                 f"static launch")
        ms = best(plan)
        results.append((ms, rows, warps))
        if verbose:
            print(f"    rows={rows:<4d} warps={warps} {ms:10.5f} ms/wave", flush=True)
    ms, rows, warps = min(results)
    return {"rows": rows, "warps": warps, "ms_per_wave": ms,
            "static_ms_per_wave": static_ms, "candidates": len(results),
            "iters": iters, "best_of": n}


def default_geometries():
    """``(cfg, batch)`` of every geometry the checked-in cache must cover:
    the reference's four, then serving at 8 and 64 slots and
    ``tnn_infer_64k``'s forward at 625 sites (this port's additions)."""
    from repro_torch.configs.tnn_mnist import (
        deep_config, default_thetas, launcher_network_config, network_config,
    )
    from repro_torch.core.network import prototype_config, with_impl

    out = []
    for sites, batch in ((16, 8), (625, 16)):
        t1, t2 = default_thetas(sites)
        out.append((network_config(sites=sites, theta1=t1, theta2=t2,
                                   impl="fused"), batch))
        out.append((deep_config(sites=sites, impl="fused"), batch))
    out.extend((launcher_network_config(625, impl="fused"), b) for b in (8, 64))
    out.append((with_impl(prototype_config(sites=625, theta1=20, theta2=6),
                          "fused"), 65536))
    return out


def check_cache(verbose: bool = True) -> int:
    """Staleness check: every default geometry must have a usable entry.
    Returns the number MISSING (0 = fresh)."""
    from repro_torch.kernels.padding import plan_geometry_key

    cache = load_cache()
    missing = 0
    for cfg, batch in default_geometries():
        key = plan_geometry_key(cfg, batch)
        if lookup(key) is not None:
            if verbose:
                e = cache[key]
                print(f"  ok      {key}: rows={e['rows']} warps={e['warps']} "
                      f"({e.get('ms_per_wave')} ms/wave; static "
                      f"{e.get('static_ms_per_wave')})")
        else:
            missing += 1
            if verbose:
                print(f"  MISSING {key}: the static rule is in effect "
                      f"(run the tuner on the card to refresh)")
    return missing


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="staleness check only: exit 1 when the cache lacks "
                         "entries for the default geometries")
    ap.add_argument("--smoke", action="store_true",
                    help="tune only the smoke (16-site) geometries")
    ap.add_argument("-n", type=int, default=5,
                    help="timings per candidate (best of n)")
    args = ap.parse_args(argv)

    path = cache_path()
    if args.check:
        dev = cache_device()
        print(f"tuned cache: {path} ({'present' if path.exists() else 'ABSENT'}); "
              f"tuned on {dev.get('nvidia_smi', 'no card recorded')}")
        missing = check_cache()
        if missing:
            print(f"autotune --check: {missing} default geometry(ies) missing: "
                  f"their launches keep the static rule")
            return 1
        print("autotune --check: OK, every default geometry has a tuned entry")
        return 0

    from repro_torch.kernels.padding import plan_geometry_key

    smi = smi_line()
    name, _, limit = smi.rpartition(",")
    cache = dict(load_cache())
    geoms = default_geometries()
    if args.smoke:
        geoms = [(c, b) for c, b in geoms if c.layers[0].n_cols <= 64]
    print(f"tuning on {smi}", flush=True)
    for cfg, batch in geoms:
        key = plan_geometry_key(cfg, batch)
        print(f"tuning {key} ...", flush=True)
        entry = tune_geometry(cfg, batch, n=args.n, verbose=True)
        print(f"  -> rows={entry['rows']} warps={entry['warps']} "
              f"({entry['ms_per_wave']:.5f} ms/wave; static "
              f"{entry['static_ms_per_wave']:.5f})", flush=True)
        cache[key] = entry
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"device": {"name": name.strip(), "power_limit": limit.strip(),
                              "nvidia_smi": smi},
                   "geometries": cache}, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(cache)} geometry entries to {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
