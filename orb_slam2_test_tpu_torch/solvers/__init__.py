"""Solvers: reprojection residuals and motion-only BA."""
