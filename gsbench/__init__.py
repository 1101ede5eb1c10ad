"""The benchmark of vcr_gaus_tpu_torch (see README.md)."""
