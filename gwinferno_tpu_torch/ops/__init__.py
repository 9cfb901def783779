"""Hand-written CUDA kernels for the likelihood hot path, each with a
plain-torch version beside it (the CPU path and the on-card oracle)."""
