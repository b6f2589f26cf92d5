"""Figures of a fit and of a run of fits (`plots.py`)."""
