"""Host ms a traced evaluated image spends inside the program's
cim.eval.prepare spans: padding the image and its proposals to their
buckets and grouping it into a stack."""
from benchmark.readers import host_ms


def read(rec):
    return host_ms(rec, "eval", ("cim.eval.prepare",))
