"""Peak device memory allocated over the evaluation window, in GiB."""
from benchmark.readers import peak_gib


def read(rec):
    return peak_gib(rec, "eval")
