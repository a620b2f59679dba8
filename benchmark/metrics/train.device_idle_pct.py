"""Share of the traced slice's window, in percent, in which no kernel or
copy ran on the device."""

from benchmark.metrics.layer import idle_pct


def read(run):
    return idle_pct(run)
