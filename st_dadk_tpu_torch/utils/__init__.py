"""Metrics and result persistence (numpy)."""
