"""Model FLOPs of the samples trained (3 x forward), over the window, over
the f32 peak (counts.PEAK_F32), %."""
from flowbench.readers import mfu


def read(readings):
    return mfu(readings, "samples", "flops_per_sample")
