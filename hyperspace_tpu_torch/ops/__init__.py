"""Device compute: plain torch ops, the hand-written CUDA kernels and the index build."""
