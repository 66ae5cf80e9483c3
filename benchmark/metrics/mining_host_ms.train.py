"""Host ms a traced training step spends inside the program's cim.mining
and cim.losses ranges (mining's NMS syncs and the losses)."""
from benchmark.readers import host_ms


def read(rec):
    return host_ms(rec, "train", ("cim.mining", "cim.losses"))
