"""Gaussian-splat clouds and their PLY files."""
