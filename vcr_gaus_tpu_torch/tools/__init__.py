"""Measurement entry points of the port (``python -m
vcr_gaus_tpu_torch.tools.<name>``)."""
