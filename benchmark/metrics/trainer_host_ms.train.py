"""Host ms a traced training step spends inside the program's cim.forward,
cim.backward and cim.optimizer ranges (launches and autograd dispatch)."""
from benchmark.readers import host_ms


def read(rec):
    return host_ms(rec, "train", ("cim.forward", "cim.backward", "cim.optimizer"))
