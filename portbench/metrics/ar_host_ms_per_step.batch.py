"""``ar_host_ms_per_step``, read as it is, in the cells that report
``audio_s_per_s.batch``: the offline batch cells, whose runs spread far less
than the served cells' and so hold a bound of their own."""
from portbench.run import read_metric


def read(ctx):
    return read_metric("ar_host_ms_per_step", ctx)
