"""Peak device memory allocated over the training window, in GiB."""
from benchmark.readers import peak_gib


def read(rec):
    return peak_gib(rec, "train")
