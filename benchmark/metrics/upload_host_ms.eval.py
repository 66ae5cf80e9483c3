"""Host ms a traced evaluated image spends inside the program's cim.upload
spans: stacking a stack's inputs and putting them, and its scales and
widths, on the card."""
from benchmark.readers import host_ms


def read(rec):
    return host_ms(rec, "eval", ("cim.upload",))
