"""Multi-layer TNNs, as in ``repro.core.network``: the paper's 2-layer MNIST
prototype (625 sites, 32x12 -> 12x10) and N-layer cascades of the same
column fabric, the image encoder, and the site-vote readout.

``impl="fused"`` runs the whole cascade as ONE wave-kernel launch per gamma
wave (``kernels.tnn_wave``); ``impl="direct"`` runs the plain per-layer
reference. Every other backend of the reference is refused until it is
ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.column import ColumnConfig
from repro_torch.core.layer import (
    LayerConfig,
    extract_patches,
    init_layer,
    layer_forward,
    layer_stdp_net,
    layer_uniforms,
)
from repro_torch.core.stdp import STDPConfig, apply_net
from repro_torch.core.temporal import SPIKE_DTYPE, WaveSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import padding as _kpad
from repro_torch.kernels import tnn_wave as _ktw

PORTED_IMPLS = ("direct", "fused")


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


def _check_impls(cfg: NetworkConfig) -> None:
    impls = {l.column.impl for l in cfg.layers}
    bad = impls - set(PORTED_IMPLS)
    if bad:
        raise ValueError(
            f"impl {sorted(bad)} is not ported yet; the port runs "
            f"{PORTED_IMPLS}")
    if impls == {"fused"} and not _kpad.fused_wave_capable(cfg):
        l_desc = [(l.n_cols, l.column.p, l.column.q) for l in cfg.layers]
        raise ValueError(
            f"impl='fused' needs a fused-wave capable network, and {l_desc} "
            f"is not (the reference falls back to per-layer 'pallas' "
            f"kernels, which are not ported yet)")
    if len(impls) > 1:
        raise ValueError(f"mixed per-layer impls {sorted(impls)} are not ported")


def with_impl(cfg: NetworkConfig, impl: str) -> NetworkConfig:
    """Rebind every layer's execution backend: ``"direct"`` (plain
    per-layer reference) or ``"fused"`` (one wave-kernel launch per gamma
    wave). ``"matmul"``/``"pallas"`` and a ``"fused"`` network the wave
    kernel cannot hold raise."""
    layers = tuple(
        dataclasses.replace(l, column=dataclasses.replace(l.column, impl=impl))
        for l in cfg.layers
    )
    out = dataclasses.replace(cfg, layers=layers)
    out.validate()
    _check_impls(out)
    return out


def init_network(gen: torch.Generator, cfg: NetworkConfig,
                 device="cuda") -> List[torch.Tensor]:
    """Random int8 weights for every layer, drawn in layer order from
    ``gen`` (on its own device) and placed on ``device``."""
    dev = resolve_device(device)
    return [init_layer(gen, l, dev) for l in cfg.layers]


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
    """True when the network runs as one wave-kernel launch per gamma wave;
    raises for any backend the port does not have."""
    _check_impls(cfg)
    return cfg.layers[0].column.impl == "fused"


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


def network_train_wave(
    x: torch.Tensor,
    params: Sequence[torch.Tensor],
    cfg: NetworkConfig,
    gen: Optional[torch.Generator] = None,
    *,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One unsupervised gamma wave through the whole network (all layers
    learn). Returns (per-layer post-WTA spike times, new per-layer weights).

    The STDP uniforms are one (C, 2, B, p, q) float32 tensor per layer, the
    shape ``layer_uniforms`` draws: pass them as ``uniforms`` (the tests
    hand the reference's draws across), or pass ``gen`` and they are drawn
    from it layer by layer."""
    for l in cfg.layers:
        l.column.stdp.require_sum()
    B = x.shape[0]
    if uniforms is None:
        if gen is None:
            raise ValueError("network_train_wave needs gen or uniforms")
        uniforms = [layer_uniforms(gen, lcfg, B, x.device) for lcfg in cfg.layers]
    elif len(uniforms) != len(cfg.layers):
        raise ValueError(f"{len(uniforms)} uniform tensors for "
                         f"{len(cfg.layers)} layers")
    if _uses_fused_wave(cfg):
        plan = _kpad.network_plan(cfg, B, n_cols=x.shape[1])
        zs, nets = _ktw.wave_train(
            x, tuple(params), tuple((u[:, 0], u[:, 1]) for u in uniforms),
            plan=plan)
        return (list(zs),
                [apply_net(w, net, lcfg.column.wave)
                 for w, net, lcfg in zip(params, nets, cfg.layers)])
    outs, new_params = [], []
    for w, lcfg, u in zip(params, cfg.layers, uniforms):
        z = layer_forward(x, w, lcfg)
        net = layer_stdp_net(x, z, w, lcfg, u[:, 0], u[:, 1])
        new_params.append(apply_net(w, net, lcfg.column.wave))
        outs.append(z)
        x = z
    return outs, new_params


def params_to_tree(params: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Weight list -> named tree ({"layer_00": w0, ...})."""
    return {f"layer_{i:02d}": w for i, w in enumerate(params)}


def params_from_tree(
    tree: Dict[str, torch.Tensor], cfg: NetworkConfig,
    n_cols: Optional[int] = None,
) -> List[torch.Tensor]:
    """Inverse of :func:`params_to_tree`; validates per-layer shapes."""
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
