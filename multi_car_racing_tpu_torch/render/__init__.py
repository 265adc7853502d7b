"""Pixel observations of the port: the scene geometry (``geometry``), the
palette (``raster``) and the 96x96 painter with its CUDA kernel
(``pixels``)."""
