"""Mean real rows per device call (the program's ``execute`` spans)."""
from flowbench.readers import mean


def read(readings):
    return mean(c[0] for c in readings.get("device_calls", ()))
