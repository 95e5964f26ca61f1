"""PyTorch/CUDA port of the TNN prototype (the JAX package ``repro`` is the
reference it is held against).

The layout mirrors ``repro``: ``core`` holds the column/layer/network
semantics, ``kernels`` the launch plans, the plain PyTorch versions of the
shared kernel bodies and the hand-written Hopper kernels (``kernels/csrc``),
``serve`` the continuous-batching engine and ``launch`` its CLI. Entry
points run on the CUDA card unless the caller passes ``device="cpu"``,
which selects the plain PyTorch path (the tests do so).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
