"""Host ms a traced training step spends inside the program's cim.sync
spans: the host's waits for the card's queue to drain."""
from benchmark.readers import host_ms


def read(rec):
    return host_ms(rec, "train", ("cim.sync",))
