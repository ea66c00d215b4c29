"""Mean host-clock ``execute`` span per device call (replay and block), ms."""
from flowbench.readers import mean


def read(readings):
    m = mean(c[2] for c in readings.get("device_calls", ()))
    return None if m is None else m * 1e3
