"""PyTorch/CUDA port of featurebase_tpu: the bitmap query engine on an
NVIDIA GPU (plain torch on the CPU for tests)."""
__version__ = "0.1.0"
