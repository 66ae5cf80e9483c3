"""Host syncs a traced training step: the program's cim.sync spans (each
NMS round's test, the metrics' read, any blocking copy) that start inside
the traced steps, per step."""
from benchmark.spans import spans_per_step


def read(rec):
    return spans_per_step(rec, "train", "cim.sync")
