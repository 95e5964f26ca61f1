"""Launch plans, plain PyTorch versions of the shared kernel bodies, and the
hand-written Hopper kernels (``csrc/``, built on first use by ``_build``)."""
