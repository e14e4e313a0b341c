"""Hand-written CUDA kernels with their ctypes wrappers and plain twins.
Importing a kernel module builds nothing; a kernel is compiled at its first
launch."""
