"""Measurement scripts of the port that run on a GPU (``python3 -m
pegasus_tpu_torch.tools.<name>`` from the repository root)."""
