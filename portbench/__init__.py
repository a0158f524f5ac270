"""The renderer's benchmark: the viewer's frame loop, driven from a seed,
timed on the card, checked against a plain reference. ``run.py`` runs one
cell of ``BENCHMARK.json``."""
