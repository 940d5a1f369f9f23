"""PyTorch port of the doppelspeller matcher for NVIDIA Hopper GPUs.

The JAX package ``doppelspeller_tpu`` is the reference; module paths mirror it.
"""

__version__ = "0.1.0"
__build__ = "cuda"
