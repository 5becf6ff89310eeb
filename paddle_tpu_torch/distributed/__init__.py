"""Distributed pieces of the port: the fleet's node registries so far
(`fleet/elastic.py`); collectives and training's elasticity are ROADMAP
A6."""
