"""Multi-layer TNNs, as in ``repro.core.network``: the paper's 2-layer MNIST
prototype (625 sites, 32x12 -> 12x10) and N-layer cascades of the same
column fabric, the image encoder, and the site-vote readout.

``impl="fused"`` runs the whole cascade as ONE wave-kernel launch per gamma
wave (``kernels.tnn_wave``) when the topology allows it; every other
network runs layer by layer through ``core.layer``: ``"pallas"`` (and a
``"fused"`` network the wave kernel cannot hold) on the per-layer kernels,
``"direct"`` and ``"matmul"`` on the plain column functions. Layers may mix
backends; all four are bit-exact with each other.

Training follows the reference's key chain (``repro_torch.random``, bit for
bit ``jax.random``): ``init_train_state`` -> ``make_train_step`` /
``make_superbatch_step`` -> ``network_train_wave``, whose STDP uniforms the
threefry kernel draws on the card.

On a (data, model) mesh (``launch.mesh.Mesh2D``; ``network_mesh_spec``) the
step factories take ``mesh=`` and run the counter-form
``network_train_step`` on the rank's local batch rows and site slice: each
rank draws only its own window of the STDP uniforms and all-reduces each
layer's int32 counters over the data axis before one saturating apply. The
cascade is same-site, so the model axis needs no collective, and integer
sums do not depend on their order: every factorization gives the unmeshed
bits.

Learning while serving (``make_online_step`` / ``make_online_superbatch_step``)
runs that train step on a shadow state and classifies the same volley under
the published weights. The readout is the site vote (``classify``) or the
winner-bit centroid (``build_centroids`` / ``classify_centroid``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import random as _random
from repro_torch.core.column import ColumnConfig
from repro_torch.core.layer import (
    LayerConfig,
    extract_patches,
    init_layer,
    layer_forward,
    layer_stdp_net,
    layer_step,
    layer_uniforms,
)
from repro_torch.core.stdp import STDPConfig, apply_net
from repro_torch.core.temporal import SPIKE_DTYPE, WaveSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import padding as _kpad
from repro_torch.kernels import tnn_wave as _ktw

PORTED_IMPLS = ColumnConfig.IMPLS


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    layers: Tuple[LayerConfig, ...]
    image_hw: Tuple[int, int] = (28, 28)
    patch_k: int = 4
    n_classes: int = 10
    # The reference's kernel-boundary dtype switch (excluded from its
    # checkpoint fingerprint). The wave kernel here always takes uint8
    # volleys and int8 weights; results are identical either way.
    packed: bool = True

    def validate(self) -> None:
        for l in self.layers:
            l.validate()

    @property
    def n_neurons(self) -> int:
        return sum(l.n_neurons for l in self.layers)

    @property
    def n_synapses(self) -> int:
        return sum(l.n_synapses for l in self.layers)


def prototype_config(
    wave: WaveSpec = WaveSpec(),
    stdp: STDPConfig = STDPConfig(),
    sites: int = 625,
    theta1: int = 24,
    theta2: int = 8,
) -> NetworkConfig:
    """The paper's 2-layer prototype (set ``sites`` small for smoke tests)."""
    l1 = LayerConfig(sites, ColumnConfig(p=32, q=12, theta=theta1, wave=wave, stdp=stdp))
    l2 = LayerConfig(sites, ColumnConfig(p=12, q=10, theta=theta2, wave=wave, stdp=stdp))
    return NetworkConfig(layers=(l1, l2))


def with_impl(cfg: NetworkConfig, impl: str) -> NetworkConfig:
    """Rebind every layer's execution backend: ``"direct"``, ``"matmul"``,
    ``"pallas"`` or ``"fused"``. Params and results do not depend on it.
    ``"fused"`` runs one wave-kernel launch per gamma wave when the topology
    allows it and per-layer ``"pallas"`` launches otherwise."""
    layers = tuple(
        dataclasses.replace(l, column=dataclasses.replace(l.column, impl=impl))
        for l in cfg.layers
    )
    out = dataclasses.replace(cfg, layers=layers)
    out.validate()
    return out


def init_network(key, cfg: NetworkConfig, device="cuda") -> List[torch.Tensor]:
    """Random int8 weights for every layer, as the reference's
    ``init_network``: layer ``i`` is ``init_layer(split(key, n_layers)[i])``.
    Drawn on the host and placed on ``device``."""
    dev = resolve_device(device)
    keys = _random.split(key, len(cfg.layers))
    return [init_layer(k, l, dev) for k, l in zip(keys, cfg.layers)]


def dog_filter(images01: torch.Tensor) -> torch.Tensor:
    """Center-surround contrast: pixel minus its 3x3 neighbourhood mean
    (edge-replicated), float32. The 9 terms are summed in the reference's
    (dr, dc) order starting from zeros, then divided by 9.0, so the result
    is bit-identical."""
    x = images01.to(torch.float32)
    pad = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    H, W = x.shape[1], x.shape[2]
    surround = torch.zeros_like(x)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            surround = surround + pad[:, 1 + dr:1 + dr + H, 1 + dc:1 + dc + W]
    surround = surround / 9.0
    return x - surround


def input_wave_spec(cfg: NetworkConfig) -> WaveSpec:
    """The wave spec the image encoder encodes against, validated across
    the cascade."""
    specs = [l.column.wave for l in cfg.layers]
    if any(s != specs[0] for s in specs):
        raise ValueError(
            f"encode_images needs one wave spec across the cascade, but the "
            f"layers disagree: {[(s.T, s.w_max) for s in specs]}")
    p_in = 2 * cfg.patch_k ** 2
    if cfg.layers[0].column.p != p_in:
        raise ValueError(
            f"input-facing layer expects fan-in {cfg.layers[0].column.p}, "
            f"but a patch_k={cfg.patch_k} on/off front end produces "
            f"{p_in} synapses per site")
    return specs[0]


def encode_images(images01: torch.Tensor, cfg: NetworkConfig) -> torch.Tensor:
    """(B, H, W) float in [0,1] -> (B, sites, 2*k*k) uint8 spike times:
    DoG contrast x 3 -> on/off half-wave rectification -> round((1 - v) * T),
    half to even. Runs on the images' device."""
    wave = input_wave_spec(cfg)
    c = dog_filter(images01) * 3.0  # contrast gain
    on = extract_patches(c.clamp(0.0, 1.0), cfg.patch_k)
    off = extract_patches((-c).clamp(0.0, 1.0), cfg.patch_k)
    t_on = torch.round((1.0 - on) * wave.T)
    t_off = torch.round((1.0 - off) * wave.T)
    out = torch.stack([t_on, t_off], dim=-1).reshape(
        on.shape[0], on.shape[1], on.shape[2] * 2)
    return out.to(SPIKE_DTYPE)


def _uses_fused_wave(cfg: NetworkConfig) -> bool:
    """True when the network runs as one wave-kernel launch per gamma wave:
    every layer selects ``"fused"`` and the topology is the wave kernel's
    (``kernels.padding.fused_wave_capable``). Any other network runs layer
    by layer, each ``"fused"`` layer as a ``"pallas"`` launch."""
    return (all(l.column.impl == "fused" for l in cfg.layers)
            and _kpad.fused_wave_capable(cfg))


def network_forward(
    x: torch.Tensor, params: Sequence[torch.Tensor], cfg: NetworkConfig
) -> List[torch.Tensor]:
    """Run all layers on x (B, C, p1); returns per-layer post-WTA spike
    times (B, C, q_i) uint8."""
    if _uses_fused_wave(cfg):
        plan = _kpad.network_plan(cfg, x.shape[0], n_cols=x.shape[1])
        return list(_ktw.wave_forward(x, tuple(params), plan=plan))
    outs = []
    for w, lcfg in zip(params, cfg.layers):
        x = layer_forward(x, w, lcfg)
        outs.append(x)
    return outs


def network_forward_superbatch(
    x_k: torch.Tensor, params: Sequence[torch.Tensor], cfg: NetworkConfig
) -> List[torch.Tensor]:
    """K forward gamma waves, wave ``i`` on ``x_k[i]`` ((K, B, C, p)): K
    :func:`network_forward` calls, as the reference's ``lax.scan``, stacked
    per layer ((K, B, C, q_i) each). Under ``impl="fused"`` each wave is one
    wave-kernel launch."""
    outs: List[List[torch.Tensor]] = [[] for _ in cfg.layers]
    for x in x_k:
        for acc, z in zip(outs, network_forward(x, params, cfg)):
            acc.append(z)
    return [torch.stack(acc) for acc in outs]


def network_train_wave(
    x: torch.Tensor,
    params: Sequence[torch.Tensor],
    cfg: NetworkConfig,
    rng=None,
    *,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One unsupervised gamma wave through the whole network (all layers
    learn). Returns (per-layer post-WTA spike times, new per-layer weights).

    Layer ``i`` learns from ``split(rng, n_layers)[i]``, as in the
    reference. Under "sum" its STDP uniforms are one (C, 2, B, p, q)
    float32 tensor drawn with ``layer_uniforms`` (on the card, by the
    threefry kernel), unless they are given as ``uniforms``; a network of
    "fused" layers runs the whole wave as one wave-kernel launch. A network
    with a "seq" or "gauss" layer runs layer by layer, each layer's forward
    on its own backend and its update in the mode's plain form
    (``layer_step``), so no wave kernel launches, as in the reference; its
    layers draw their own randomness, and ``uniforms`` is refused."""
    sum_only = _sum_only(cfg)
    if uniforms is not None:
        if not sum_only:
            raise ValueError(
                "uniforms= are the 'sum' form's draws; a network with a "
                "'seq' or 'gauss' layer draws its own from rng")
        if len(uniforms) != len(cfg.layers):
            raise ValueError(f"{len(uniforms)} uniform tensors for "
                             f"{len(cfg.layers)} layers")
    elif rng is None:
        raise ValueError("network_train_wave needs rng or uniforms")
    if sum_only and _uses_fused_wave(cfg):
        if uniforms is None:
            uniforms = _draw_uniforms(rng, cfg, x.shape[0], x.device)
        return _fused_train(x, params, cfg, uniforms)
    keys = (_random.split(rng, len(cfg.layers)) if uniforms is None
            else [None] * len(cfg.layers))
    outs, new_params = [], []
    for i, (w, lcfg, k) in enumerate(zip(params, cfg.layers, keys)):
        u = None if uniforms is None else uniforms[i]
        x, w = layer_step(x, w, lcfg, k, uniforms=u)
        new_params.append(w)
        outs.append(x)
    return outs, new_params


def _sum_only(cfg: NetworkConfig) -> bool:
    """Every layer takes the batched "sum" STDP (the wave kernel's
    epilogue implements only that form)."""
    return all(l.column.stdp.batch_reduce == "sum" for l in cfg.layers)


def _draw_uniforms(rng, cfg: NetworkConfig, B: int, device,
                   spec: Optional[_kpad.MeshSpec] = None) -> List[torch.Tensor]:
    """Every layer's wave uniforms from the wave key, as the reference splits
    it: one key per layer, then one per column inside ``layer_uniforms``.
    With a mesh's ``spec`` each layer draws only this rank's window of the
    global (C, 2, B, p, q) uniforms."""
    keys = _random.split(rng, len(cfg.layers))
    return [_layer_draw(k, lcfg, B, device, spec) for k, lcfg in zip(keys, cfg.layers)]


def _layer_draw(key, lcfg, B: int, device, spec: Optional[_kpad.MeshSpec]):
    """One layer's uniforms: the whole layer, or ``spec``'s rank window."""
    window = (None if spec is None
              else spec.uniform_window(lcfg.n_cols, B // spec.n_data))
    return layer_uniforms(key, lcfg, B, device, window=window)


def _fused_train(x, params, cfg: NetworkConfig, uniforms,
                 reduce: Callable[[torch.Tensor], torch.Tensor] = lambda net: net):
    """The whole learning wave as one wave-kernel launch over x's sites; each
    layer's counters go through ``reduce`` (a mesh's sum over "data") and
    are applied once."""
    plan = _kpad.network_plan(cfg, x.shape[0], n_cols=x.shape[1])
    zs, nets = _ktw.wave_train(
        x, tuple(params), tuple((u[:, 0], u[:, 1]) for u in uniforms),
        plan=plan)
    return (list(zs),
            [apply_net(w, reduce(net), lcfg.column.wave)
             for w, net, lcfg in zip(params, nets, cfg.layers)])


def network_mesh_spec(cfg: NetworkConfig, mesh) -> _kpad.MeshSpec:
    """The sharding contract of every step factory, the engine and the
    trainer: ``mesh``'s (data, model) factorization (``None`` = unsharded)
    bound to the config's site count and this rank. Model-axis sharding
    slices the column fabric, so it needs one site count across the
    cascade."""
    spec = _kpad.MeshSpec.from_mesh(mesh, cfg.layers[0].n_cols)
    if spec.n_model > 1:
        cols = {l.n_cols for l in cfg.layers}
        if len(cols) != 1:
            raise ValueError(
                f"model-axis sharding slices the site/column axis and needs "
                f"one site count across the cascade, got {sorted(cols)} — "
                f"serve heterogeneous-site networks with model=1")
    return spec


def network_train_step(
    x: torch.Tensor,
    params: Sequence[torch.Tensor],
    cfg: NetworkConfig,
    rng,
    *,
    mesh=None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One gamma wave of online STDP in counter form, bit-exact with
    :func:`network_train_wave`, as the reference's ``network_train_step``.

    x: (b, C_loc, p) spike times: with a ``mesh`` the rank's local batch
    rows and (padded) site slice, else the whole batch. Each layer draws
    only this rank's window of the global (C, 2, B = b x n_data, p, q)
    uniforms (``layer_uniforms(window=...)``: the same per-layer and
    per-column keys, pad sites 1.0), computes its local int32 net counters
    and all-reduces them over the data axis before one saturating apply.
    Under "fused" the wave kernel runs over the local sites; otherwise each
    layer runs its forward and its STDP kernel (or plain counters) in net
    form. Returns (per-layer post-WTA spike times, new per-layer weights).
    """
    spec = network_mesh_spec(cfg, mesh)
    b_local, c_local = x.shape[0], x.shape[1]
    if mesh is not None and spec.n_model > 1 and c_local != spec.local_cols:
        raise ValueError(f"x holds {c_local} sites, the rank's slice is "
                         f"{spec.local_cols}")
    B = b_local * spec.n_data
    rank_spec = None if mesh is None else spec

    def reduce(net):
        return net if mesh is None else mesh.all_reduce_sum(net, "data")

    if _uses_fused_wave(cfg) and _sum_only(cfg):
        return _fused_train(x, params, cfg,
                            _draw_uniforms(rng, cfg, B, x.device, rank_spec), reduce)
    new_params, outs = [], []
    for w, lcfg, k in zip(params, cfg.layers, _random.split(rng, len(cfg.layers))):
        z = layer_forward(x, w, lcfg)
        u = _layer_draw(k, lcfg, B, x.device, rank_spec)
        net = reduce(layer_stdp_net(x, z, w, lcfg, u[:, 0], u[:, 1]))
        new_params.append(apply_net(w, net, lcfg.column.wave))
        outs.append(z)
        x = z
    return outs, new_params


# ---------------------------------------------------------------------------
# Training steps: the weights updated in place
# ---------------------------------------------------------------------------


def superbatch_keys(rng, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-split K per-wave step keys from ONE stream key by the chained
    ``split`` the sequential trainer performs (wave i's key is the second
    half of the i-th split), as the reference's ``superbatch_keys``. Returns
    ``(advanced stream key, (K, 2) per-wave keys)``."""
    key, subs = _random.as_key(rng), []
    for _ in range(k):
        key, sub = _random.split(key)
        subs.append(sub)
    return key, torch.stack(subs) if subs else torch.empty((0, 2), dtype=torch.uint32)


def network_train_superbatch(
    x_k: torch.Tensor,
    params: Sequence[torch.Tensor],
    cfg: NetworkConfig,
    keys_k: torch.Tensor,
    *,
    mesh=None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """K consecutive learning waves, wave ``i`` on ``(x_k[i], keys_k[i])``:
    K :func:`network_train_wave` calls (with a ``mesh``, K meshed
    :func:`network_train_step` calls on the local windows), as the
    reference's ``lax.scan``. Returns (per-layer z stacks ((K, B, C, q_i)
    each), final weights). Only the "sum" form: the reference's superbatch
    runs the counter form."""
    for l in cfg.layers:
        l.column.stdp.require_counter_form()
    params = list(params)
    outs: List[List[torch.Tensor]] = [[] for _ in cfg.layers]
    for x, key in zip(x_k, keys_k):
        if mesh is None:
            zs, params = network_train_wave(x, params, cfg, key)
        else:
            zs, params = network_train_step(x, params, cfg, key, mesh=mesh)
        for acc, z in zip(outs, zs):
            acc.append(z)
    return [torch.stack(acc) for acc in outs], params


def _update_in_place(params: Sequence[torch.Tensor], new: Sequence[torch.Tensor]) -> None:
    """Write the new weights into the state's tensors: the reference donates
    the state to its jitted step, so its update is in place too."""
    for w, nw in zip(params, new):
        w.copy_(nw)


TrainState = Dict[str, object]
TrainStep = Callable[[TrainState, torch.Tensor], Tuple[TrainState, torch.Tensor]]


def local_param_cols(cfg: NetworkConfig, mesh) -> Optional[int]:
    """The site extent of a rank's weights, as :func:`params_from_tree`
    takes it: the model shard's slice when the model axis shards the
    sites, else the config's (``None``)."""
    spec = network_mesh_spec(cfg, mesh)
    return spec.local_cols if spec.n_model > 1 else None


def local_tree(tree: Dict[str, torch.Tensor], cfg: NetworkConfig, mesh
               ) -> Dict[str, torch.Tensor]:
    """A global params tree -> this mesh rank's: every layer's site slice,
    padded, as new tensors (the tree itself without a mesh)."""
    if mesh is None:
        return tree
    spec = network_mesh_spec(cfg, mesh)
    return params_to_tree(spec.local_weights(params_from_tree(tree, cfg)))


def logical_params(tree: Dict[str, torch.Tensor], cfg: NetworkConfig,
                   mesh=None) -> List[torch.Tensor]:
    """A rank's params tree -> the logical per-layer weights, gathered over
    the model axis on a mesh (a collective: every rank calls it)."""
    ps = params_from_tree(tree, cfg, n_cols=local_param_cols(cfg, mesh))
    if mesh is None:
        return ps
    spec = network_mesh_spec(cfg, mesh)
    return [mesh.gather_sites(w, spec) for w in ps]


def make_train_step(cfg: NetworkConfig, mesh=None) -> TrainStep:
    """The production train step ``(state, x) -> (state, z)``, as the
    reference's ``make_train_step``.

    ``state`` is ``{"params": {"layer_NN": int8}, "rng": (2,) uint32 key,
    "wave": int32}``; ``x`` is one encoded wave batch (B, C, p) on the
    weights' device. The key chain is the reference's: ``key, sub =
    split(state["rng"])``, the wave runs on ``sub``. The weights are updated
    in place (the reference donates the state), so callers keep only the
    returned state. ``z`` is the last layer's post-WTA spike times.

    With a ``mesh`` the step takes and returns the rank's LOCAL state
    (site-padded weight slices; the key and wave are replicated) and its
    local x and z windows (``MeshSpec.local_spikes``), and runs the meshed
    :func:`network_train_step`: the same bits under any factorization."""
    _require_sum(cfg, "make_train_step")
    n_cols = local_param_cols(cfg, mesh)

    def step(state: TrainState, x: torch.Tensor):
        params = params_from_tree(state["params"], cfg, n_cols=n_cols)
        key, sub = _random.split(state["rng"])
        if mesh is None:
            outs, new_params = network_train_wave(x, params, cfg, sub)
        else:
            outs, new_params = network_train_step(x, params, cfg, sub, mesh=mesh)
        _update_in_place(params, new_params)
        return {"params": state["params"], "rng": key,
                "wave": state["wave"] + 1}, outs[-1]

    return step


def make_superbatch_step(cfg: NetworkConfig, mesh=None) -> TrainStep:
    """The K-wave train step ``(state, x_k) -> (state, z_k)``, as the
    reference's ``make_superbatch_step``: ``x_k`` is (K, B, C, p) and K is
    read from its shape; the per-wave keys are pre-split by
    :func:`superbatch_keys`, so the result equals K :func:`make_train_step`
    calls bit for bit; the weights are updated in place and the wave counter
    advances by K. ``z_k`` stacks the last layer's spike times per wave.
    With a ``mesh``, local state and windows as :func:`make_train_step`'s."""
    _require_sum(cfg, "make_superbatch_step")
    n_cols = local_param_cols(cfg, mesh)

    def step(state: TrainState, x_k: torch.Tensor):
        k = x_k.shape[0]
        params = params_from_tree(state["params"], cfg, n_cols=n_cols)
        key, subs = superbatch_keys(state["rng"], k)
        outs, new_params = network_train_superbatch(x_k, params, cfg, subs,
                                                    mesh=mesh)
        _update_in_place(params, new_params)
        return {"params": state["params"], "rng": key,
                "wave": state["wave"] + k}, outs[-1]

    return step


def init_train_state(key, cfg: NetworkConfig, device="cuda") -> TrainState:
    """Fresh training state for :func:`make_train_step`, as the reference's
    ``init_train_state``: ``k_params, k_stream = split(key)``, weights from
    ``k_params`` on ``device``, the stream key ``k_stream`` and wave 0 on the
    host."""
    k_params = _random.split(key)[0]
    return {"params": params_to_tree(init_network(k_params, cfg, device)),
            **train_stream_start(key)}


def train_stream_start(key) -> TrainState:
    """The key and wave counter :func:`init_train_state` starts from
    (``split(key)[1]`` and wave 0), without drawing its weights."""
    return {"rng": _random.split(key)[1],
            "wave": torch.tensor(0, dtype=torch.int32)}


# ---------------------------------------------------------------------------
# Learning while serving: classify under published weights, learn on a shadow
# ---------------------------------------------------------------------------

OnlineStep = Callable[[Sequence[torch.Tensor], TrainState, torch.Tensor],
                      Tuple[TrainState, torch.Tensor]]


def _require_sum(cfg: NetworkConfig, what: str) -> None:
    """The reference's refusal of "seq"/"gauss" by the step factories."""
    for l in cfg.layers:
        l.column.stdp.require_sum(what)


def make_online_step(cfg: NetworkConfig, mesh=None) -> OnlineStep:
    """The learn-while-serving step ``(serve_params, state, x) -> (state,
    z_serve)``, as the reference's ``make_online_step``. With a ``mesh``
    the serving weights, the state, x and z are the rank's local windows.

    The shadow half is :func:`make_train_step`'s body on ``state`` (the same
    key split, the weights updated in place, the wave counter + 1), so N
    online waves equal N trainer steps on the same volleys. The served half
    is :func:`network_forward` under ``serve_params``, which must not alias
    the state's weights: the next wave would update them under requests
    still in flight. Pad rows (spike time T) fire nothing and learn
    nothing."""
    _require_sum(cfg, "make_online_step")
    train = make_train_step(cfg, mesh)

    def step(serve_params, state: TrainState, x: torch.Tensor):
        state, _ = train(state, x)
        return state, network_forward(x, list(serve_params), cfg)[-1]

    return step


def make_online_superbatch_step(cfg: NetworkConfig, mesh=None) -> OnlineStep:
    """The K-wave form of :func:`make_online_step`: ``(serve_params, state,
    x_k) -> (state, z_k)`` with ``x_k`` (K, B, C, p). The shadow learns
    through :func:`make_superbatch_step` (the :func:`superbatch_keys`
    pre-split, wave counter + K), so it equals K online steps; the K waves
    are classified under the one ``serve_params``; with a ``mesh``, local
    windows as :func:`make_online_step`'s."""
    _require_sum(cfg, "make_online_superbatch_step")
    train = make_superbatch_step(cfg, mesh)

    def step(serve_params, state: TrainState, x_k: torch.Tensor):
        state, _ = train(state, x_k)
        return state, network_forward_superbatch(x_k, list(serve_params), cfg)[-1]

    return step


def params_to_tree(params: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Weight list -> named tree ({"layer_00": w0, ...})."""
    return {f"layer_{i:02d}": w for i, w in enumerate(params)}


def params_from_tree(
    tree: Dict[str, torch.Tensor], cfg: NetworkConfig,
    n_cols: Optional[int] = None,
) -> List[torch.Tensor]:
    """Inverse of :func:`params_to_tree`; validates per-layer shapes.
    ``n_cols`` overrides the expected site extent: on a model-sharded mesh a
    rank holds a local (padded) site slice of every layer's weights."""
    params = []
    for i, lcfg in enumerate(cfg.layers):
        key = f"layer_{i:02d}"
        if key not in tree:
            raise KeyError(f"params tree missing {key} (have {sorted(tree)})")
        w = tree[key]
        want = (lcfg.n_cols if n_cols is None else n_cols,
                lcfg.column.p, lcfg.column.q)
        if tuple(w.shape) != want:
            raise ValueError(f"{key}: shape {tuple(w.shape)} != {want}")
        params.append(w)
    return params


ForwardFn = Callable[[Sequence[torch.Tensor], torch.Tensor], torch.Tensor]


def forward_all_padded(forward_fn: ForwardFn, params, x: torch.Tensor,
                       batch: int, T: int) -> torch.Tensor:
    """Chunked fixed-shape forward over any number of encoded rows: slice
    ``x`` (N, C, p) into ``batch``-row chunks, pad the ragged tail with the
    no-op spike time ``T`` and concatenate the last layer's times back to
    (N, C, q). ``forward_fn(params, chunk)`` returns the last layer's z."""
    outs = []
    for off in range(0, x.shape[0], batch):
        chunk = x[off:off + batch]
        k = chunk.shape[0]
        chunk = _kpad.pad_batch_rows(chunk, batch, T)
        outs.append(forward_fn(params, chunk)[:k])
    return torch.cat(outs, dim=0)


def refresh_vote_table(forward_fn: ForwardFn, params, x: torch.Tensor, labels,
                       cfg: NetworkConfig, batch: int) -> torch.Tensor:
    """One labelled pass -> vote table (sites, q, n_classes) for the given
    weights."""
    T = cfg.layers[-1].column.wave.T
    z = forward_all_padded(forward_fn, params, x, batch, T)
    labels = torch.as_tensor(labels, dtype=torch.int64, device=z.device)
    return build_vote_table(z, labels, cfg.n_classes, T)


# ---------------------------------------------------------------------------
# Unsupervised readout: label neurons by the classes they win on, then vote.
# ---------------------------------------------------------------------------


def winner_map(z_last: torch.Tensor, T: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (batch, site): winning neuron index (the first earliest spike,
    index 0 when none fired) and the fired mask. z: (B, S, q)."""
    zi = z_last.to(torch.int32)
    q = zi.shape[-1]
    idx = torch.arange(q, dtype=torch.int32, device=zi.device)
    winner = ((zi * q + idx).amin(dim=-1) % q).long()
    fired = (zi < T).any(dim=-1)
    return winner, fired


def build_vote_table(
    z_last: torch.Tensor, labels: torch.Tensor, n_classes: int, T: int
) -> torch.Tensor:
    """Histogram (sites, q, n_classes) float32: how often neuron (s, j) wins
    on class c. Every entry is a whole-number count."""
    B, S, q = z_last.shape
    winner, fired = winner_map(z_last, T)  # (B, S)
    onehot_w = F.one_hot(winner, q).to(torch.float32) * fired[..., None]
    onehot_c = F.one_hot(labels.long(), n_classes).to(torch.float32)  # (B, C)
    return torch.einsum("bsq,bc->sqc", onehot_w, onehot_c)


def classify(z_last: torch.Tensor, vote_table: torch.Tensor, T: int,
             soft: bool = True) -> torch.Tensor:
    """Vote of per-site winner labels. Returns (B,) class ids (int64).

    ``soft=True`` weights each firing site's vote by its empirical class
    posterior P(c | site, winner); ``soft=False`` is the plain majority
    vote of argmax site labels. Ties go to the lowest class id."""
    return vote_sums(z_last, vote_table, T, soft).argmax(dim=-1)


def vote_sums(z_last: torch.Tensor, vote_table: torch.Tensor, T: int,
              soft: bool = True) -> torch.Tensor:
    """The (B, n_classes) float32 vote sums :func:`classify` takes the
    argmax of."""
    winner, fired = winner_map(z_last, T)  # (B, S)
    n_classes = vote_table.shape[-1]
    S = vote_table.shape[0]
    sites = torch.arange(S, device=winner.device)[None, :]
    if soft:
        post = vote_table / vote_table.sum(dim=-1, keepdim=True).clamp_min(1.0)
        votes = post[sites, winner] * fired[..., None]  # (B, S, C)
    else:
        site_label = vote_table.argmax(dim=-1)  # (S, q)
        lab = site_label[sites, winner]          # (B, S)
        votes = (F.one_hot(lab, n_classes).to(torch.float32)
                 * fired[..., None])
    return votes.sum(dim=1)


def winner_bits(z_last: torch.Tensor, T: int) -> torch.Tensor:
    """(B, S, q) post-WTA spike times -> (B, S*q) bool winner map: one bit
    per neuron per gamma wave, the code the readout hardware sees."""
    return (z_last.to(torch.int32) < T).reshape(z_last.shape[0], -1)


def build_centroids(z_last: torch.Tensor, labels: torch.Tensor, n_classes: int,
                    T: int) -> torch.Tensor:
    """Per-class mean winner-bit vectors (n_classes, S*q) float32: whole
    counts divided by the class size (at least 1), as the reference's."""
    bits = winner_bits(z_last, T).to(torch.float32)
    onehot = F.one_hot(labels.long(), n_classes).to(torch.float32)  # (B, C)
    sums = torch.einsum("bf,bc->cf", bits, onehot)
    counts = onehot.sum(dim=0).clamp_min(1.0)
    return sums / counts[:, None]


def classify_centroid(z_last: torch.Tensor, centroids: torch.Tensor,
                      T: int) -> torch.Tensor:
    """Nearest centroid on the winner bits (squared distance; ties go to the
    lowest class id). Returns (B,) class ids (int64)."""
    bits = winner_bits(z_last, T).to(torch.float32)
    d = (bits[:, None, :] - centroids[None]).square().sum(dim=-1)
    return d.argmin(dim=-1)
