"""The lookup kernel's (B1, csrc/corr_lookup.cu) share of its roofline:
bound time over profiled device time, per call, %."""
from flowbench.readers import B1_KERNEL, B1_LAUNCHES, roofline


def read(readings):
    return roofline(readings, B1_KERNEL, B1_LAUNCHES, "b1_call_s")
