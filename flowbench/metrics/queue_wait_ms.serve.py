"""Mean wait of a request in the admission queue and the micro-batcher
(the program's ``queue_wait`` spans), ms."""
from flowbench.readers import mean


def read(readings):
    m = mean(readings.get("queue_wait_s", ()))
    return None if m is None else m * 1e3
