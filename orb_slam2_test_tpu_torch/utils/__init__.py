"""Support code: the CUDA kernel builder and precision flags."""
