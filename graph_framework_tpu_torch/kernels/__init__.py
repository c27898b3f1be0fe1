"""Hand-written CUDA kernels, their wrappers and plain versions, and their
build (``nvcc`` at first use; nothing is built at import)."""
