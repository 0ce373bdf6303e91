"""Measurement on the card (``measure``, the front end's step clock
``wall_clock``): CUDA events only; the benchmark Report schema
(``report``)."""
