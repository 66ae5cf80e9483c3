"""The model FLOPs of the window's training steps over its seconds and the
card's dense bf16 peak, in %."""
from benchmark.readers import mfu


def read(rec):
    return mfu(rec, "train")
