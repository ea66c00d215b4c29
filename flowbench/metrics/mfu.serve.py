"""Model FLOPs of the pairs completed, over the window, over the f32 peak
(counts.PEAK_F32), %."""
from flowbench.readers import mfu


def read(readings):
    return mfu(readings, "pairs", "flops_per_pair")
