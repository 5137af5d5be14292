"""Core geometry: pinhole camera, SE3, robust-loss constants."""
