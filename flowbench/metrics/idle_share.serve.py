"""Share of the traced window in which no operation ran on the device, %."""
from flowbench.readers import idle_share


def read(readings):
    return idle_share(readings)
