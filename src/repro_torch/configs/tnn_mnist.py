"""tnn-mnist, the paper's own architecture (Fig. 19): the 2-layer TNN
prototype, 625 columns of 32x12 -> 625 columns of 12x10 (13,750 neurons,
315,000 synapses), as in ``repro.configs.tnn_mnist``.

Reduced ``sites`` (smoke tests, CPU runs) must be a perfect square S = s*s;
the matching input field is then (s+3, s+3) pixels.
"""
import dataclasses
import math
import pathlib

from repro_torch.core.column import ColumnConfig
from repro_torch.core.layer import LayerConfig
from repro_torch.core.network import NetworkConfig, prototype_config, with_impl
from repro_torch.core.stdp import STDPConfig
from repro_torch.core.temporal import WaveSpec

# where the train launcher checkpoints by default: inside the checkout, in a
# directory .gitignore lists
DEFAULT_CKPT_DIR = str(pathlib.Path(__file__).resolve().parents[3] / "build" / "tnn_ckpt")

WAVE = WaveSpec(time_bits=3, weight_bits=3)
STDP = STDPConfig()
PATCH_K = 4


def image_side(sites: int, patch_k: int = PATCH_K) -> int:
    """Input field side length for a square grid of ``sites`` patch sites."""
    s = math.isqrt(sites)
    if s * s != sites:
        raise ValueError(f"sites={sites} is not a perfect square")
    return s + patch_k - 1


def crop_field(images, sites: int):
    """Centered crop of (B, H, W) images to the field a ``sites`` grid needs
    (identity for the full 625-site / 28x28 geometry)."""
    side = image_side(sites)
    B, H, W = images.shape
    if side > H or side > W:
        raise ValueError(
            f"sites={sites} needs a {side}x{side} field but images are {H}x{W}")
    r0, c0 = (H - side) // 2, (W - side) // 2
    return images[:, r0:r0 + side, c0:c0 + side]


def default_thetas(sites: int):
    """The launchers' convention: the paper's thresholds at full geometry,
    lowered for reduced fields so units still fire. At 625 sites layer 2's
    theta=8 is out of reach (1-WTA leaves at most one input spike per
    layer-2 column, so its potential is at most w_max=7); the reference
    behaves so and the port reproduces it."""
    return (24, 8) if sites >= 625 else (12, 3)


def network_config(sites: int = 625, theta1: int = 24, theta2: int = 8,
                   impl: str = "direct"):
    side = image_side(sites)
    cfg = prototype_config(
        wave=WAVE, stdp=STDP, sites=sites, theta1=theta1, theta2=theta2
    )
    cfg = dataclasses.replace(cfg, image_hw=(side, side))
    return with_impl(cfg, impl)


def deep_config(sites: int = 625, widths=(12, 12, 10), thetas=None,
                impl: str = "direct"):
    """An N-layer same-site cascade over the paper's column fabric: layer 1
    = ``sites`` columns of 32 x ``widths[0]``, layer i>1 = ``sites`` columns
    of ``widths[i-1]`` x ``widths[i]``. ``thetas`` defaults to the launcher
    convention (input layer, then the downstream threshold)."""
    if not widths:
        raise ValueError("deep_config needs at least one layer width")
    side = image_side(sites)
    if thetas is None:
        t_in, t_deep = default_thetas(sites)
        thetas = (t_in,) + (t_deep,) * (len(widths) - 1)
    if len(thetas) != len(widths):
        raise ValueError(
            f"got {len(thetas)} thetas for {len(widths)} layer widths")
    layers, p = [], 2 * PATCH_K ** 2
    for q, theta in zip(widths, thetas):
        layers.append(LayerConfig(
            sites, ColumnConfig(p=p, q=q, theta=theta, wave=WAVE, stdp=STDP)))
        p = q
    cfg = NetworkConfig(layers=tuple(layers), image_hw=(side, side))
    return with_impl(cfg, impl)


def launcher_network_config(sites: int, depth: int = 2,
                            impl: str = "direct", packed: bool = True):
    """The network the launchers build from their flags: ``depth=2`` is the
    paper prototype under ``default_thetas``; any other depth is the
    ``deep_config`` cascade with 12-wide hidden layers and a 10-wide
    readout layer."""
    if depth < 1:
        raise ValueError(f"depth={depth}")
    if depth == 2:
        theta1, theta2 = default_thetas(sites)
        cfg = network_config(sites=sites, theta1=theta1, theta2=theta2,
                             impl=impl)
    else:
        widths = (12,) * (depth - 1) + (10,)
        cfg = deep_config(sites=sites, widths=widths, impl=impl)
    return dataclasses.replace(cfg, packed=packed)


def train_config(sites: int = 625, smoke: bool = False, **overrides):
    """Trainer hyper-parameters for the prototype, as the reference's
    ``train_config``: at full geometry 16-image waves over a 512-image
    labelled set and 256 held-out images; ``smoke=True`` or fewer than 625
    sites shrinks that to 8 / 64 / 32. Keyword overrides are applied last."""
    from repro_torch.train.tnn_trainer import TNNTrainConfig

    kw = dict(epochs=1, wave_batch=16, train_size=512, eval_size=256,
              ckpt_dir=DEFAULT_CKPT_DIR)
    if smoke or sites < 625:
        kw.update(wave_batch=8, train_size=64, eval_size=32, log_every=2)
    kw.update(overrides)
    return TNNTrainConfig(**kw)
