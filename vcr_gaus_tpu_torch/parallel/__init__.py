"""Multi-device parallelism of the port (vcr_gaus_tpu/parallel)."""
