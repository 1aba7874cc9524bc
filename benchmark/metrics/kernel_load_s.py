"""Host seconds of kernels.build over the cell's CUDA sources (nvcc on a
checkout's first run, a load from build/ after)."""


def read(s):
    return s.get("kernel_load_s")
