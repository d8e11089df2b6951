"""Box math, decode, NMS and the CUDA kernels with their plain versions."""
