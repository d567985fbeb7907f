"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers, and
their plain PyTorch versions (``ref``).  Importing builds nothing: the
first launch builds the library (see ``_build``)."""
