"""Helpers shared by the launchers, ``chip_smoke.py`` and the tests."""
