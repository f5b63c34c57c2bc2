"""Photometry operators (knot tables, shift interpolation, the K1-K3
kernels) and the SFZH kernel."""
