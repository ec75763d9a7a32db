"""Device compute: image stencils, corner detection, pyramidal LK, patch
descriptors and their matcher, SIFT, RANSAC, 8-point/E, DLT, P3P, small SPD
solves, and the CUDA kernels (kernels.py)."""
