"""Host time of the program's spans in the traced slice: the spans are
``record_function`` ranges, host records of the slice on the tracer's own
clock. The benchmark imports nothing of the program, so each reader names
its span in full."""

from __future__ import annotations


def host_ms_per_item(run, name: str):
    """Host ms a step or a request of the slice's records named ``name``
    (a name that ends in ``#``: whose name starts with it), None where the
    slice holds none. Unlike the device readers it also reads on the CPU."""
    if run.trace is None or not run.slice_shapes:
        return None
    if name.endswith("#"):
        spans = [e - s for n, s, e in run.trace.host if n.startswith(name)]
    else:
        spans = [e - s for n, s, e in run.trace.host if n == name]
    if not spans:
        return None
    return sum(spans) / 1e6 / len(run.slice_shapes)
