"""Roofline model of the port on one card (``analysis``)."""
