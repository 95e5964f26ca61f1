"""The TNN prototype's online-STDP trainer."""
