"""Device compute: image stencils, corner detection, pyramidal LK, RANSAC,
8-point/E, DLT, P3P, small SPD solves, and the CUDA kernels (kernels.py)."""
