"""Measurement on the card (``measure``): CUDA events only."""
