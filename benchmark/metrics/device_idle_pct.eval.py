"""The share of the traced evaluation window in which no device operation
ran, in %."""
from benchmark.readers import idle_pct


def read(rec):
    return idle_pct(rec, "eval")
