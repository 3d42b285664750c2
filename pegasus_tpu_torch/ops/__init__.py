"""Projection, binning, compositing and the modality encoders."""
