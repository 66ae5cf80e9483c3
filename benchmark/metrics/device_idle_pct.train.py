"""The share of the traced training steps in which no device operation
ran, in %."""
from benchmark.readers import idle_pct


def read(rec):
    return idle_pct(rec, "train")
