"""PyTorch + CUDA port of the DeepLearningKit reproduction.

Mirrors ``repro``'s sub-packages (configs, core, kernels, runtime,
models); the Pallas kernels become hand-written CUDA C++ kernels for
Hopper under ``kernels/csrc``.  Entry points run on the CUDA device
unless the caller passes ``device="cpu"``.
"""
