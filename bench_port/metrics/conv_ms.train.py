"""Device milliseconds per train step in the encoder's and decoder's library
products: cuDNN's convolutions with their layout transposes, and cuBLAS's
products for the kernel-size-1 convolutions and linear layers
(``benchlib.readers.CONV_KERNELS`` name patterns)."""

from benchlib.readers import CONV_KERNELS, kernel_ms_per_unit


def read(run):
    return kernel_ms_per_unit(run, CONV_KERNELS)
