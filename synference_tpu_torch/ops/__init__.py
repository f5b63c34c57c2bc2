"""Photometry operators: knot tables, shift interpolation and the K1 kernel."""
