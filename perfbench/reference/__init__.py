"""Plain PyTorch references of the benchmarked models: fp32, no kernels,
no cache, no batching; they import nothing of the program."""
