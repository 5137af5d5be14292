"""Support code: the CUDA kernel builder, precision flags, scatters, the
stage profiler and synthetic scenes."""
