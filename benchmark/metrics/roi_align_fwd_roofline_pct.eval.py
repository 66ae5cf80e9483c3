"""The RoIAlign forward kernel's share of its roofline in the traced
evaluation window, in %."""
from benchmark.readers import roofline


def read(rec):
    return roofline(rec, "eval", "fwd")
