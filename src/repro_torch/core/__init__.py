"""The paper's contribution: on-device inference infrastructure.

graph       layer-graph runtime (the Metal pipeline equivalent)
ops         op registry: shapes, costs, Caffe schema, ref/cuda/fft backends
importer    Caffe-like JSON model interchange (paper section 3)
modelstore  App Store for Deep Learning Models (paper section 2)
engine      command-queue inference engine (paper figure 2)
quantize    int8 weights for the store
fftconv     FFT convolution with precalculated filters (roadmap item 1)
compress    low-rank, pruning and int8 stages (roadmap items 7 and 8)
"""
