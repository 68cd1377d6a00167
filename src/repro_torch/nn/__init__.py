"""Layers, params and the Mamba-2 mixer of the port."""
