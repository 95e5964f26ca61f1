"""Deterministic data sources (numpy)."""
