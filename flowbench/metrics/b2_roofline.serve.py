"""The SepConvGRU kernel's (B2, csrc/sep_conv_gru.cu) share of its
roofline: bound time over profiled device time, per call, %."""
from flowbench.readers import B2_KERNEL, B2_LAUNCHES, roofline


def read(readings):
    return roofline(readings, B2_KERNEL, B2_LAUNCHES, "b2_row_s")
