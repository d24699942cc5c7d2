"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version, with wrappers that launch the kernel for tensors on the
card and run the plain version for tensors on the CPU."""
