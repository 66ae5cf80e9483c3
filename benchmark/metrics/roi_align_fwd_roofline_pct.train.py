"""The RoIAlign forward kernel's share of its roofline in the traced
training steps, in %."""
from benchmark.readers import roofline


def read(rec):
    return roofline(rec, "train", "fwd")
