"""Field arithmetic, checksums and the CUDA kernels of the data path."""
