"""The model FLOPs of the window's evaluated images (all 10 passes) over
its seconds and the card's dense bf16 peak, in %."""
from benchmark.readers import mfu


def read(rec):
    return mfu(rec, "eval")
