"""Share of the traced window in which no operation ran on the device:
1 - (union of its kernel, copy and set intervals) / the window.  Read
under torch.profiler, which slows the host's enqueue: the idle share it
reads is an upper bound on the unprofiled window's, and its busy share a
lower bound."""
from benchmark.readers import idle_share


def read(ctx):
    return idle_share(ctx)
