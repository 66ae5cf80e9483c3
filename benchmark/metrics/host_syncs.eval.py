"""Host syncs a traced evaluated image: the program's cim.sync spans (each
stack's blocking uploads and the read of its scores) that start inside the
traced evaluation window, per image."""
from benchmark.spans import spans_per_step


def read(rec):
    return spans_per_step(rec, "eval", "cim.sync")
