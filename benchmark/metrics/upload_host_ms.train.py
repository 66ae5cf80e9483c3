"""Host ms a traced training step spends inside the program's cim.upload
spans: putting each microbatch's inputs on the card."""
from benchmark.readers import host_ms


def read(rec):
    return host_ms(rec, "train", ("cim.upload",))
