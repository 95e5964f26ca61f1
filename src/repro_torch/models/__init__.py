"""LM models: parameter specs, transformer layers, MoE and the model forwards."""
