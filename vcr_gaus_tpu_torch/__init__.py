"""PyTorch/CUDA port of vcr_gaus_tpu for one NVIDIA H100.

Same subpackage and module names as ``vcr_gaus_tpu`` so each counterpart is
found at once. The port imports torch and never jax, nor anything of the
JAX package. Entry points take ``device`` (default ``"cuda"``) and raise
when CUDA is absent and the caller did not ask for ``"cpu"``.
"""

__version__ = "0.1.0"
