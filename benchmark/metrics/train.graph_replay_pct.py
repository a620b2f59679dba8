"""Share of the traced slice's train steps, in percent, that replayed a
CUDA graph of the whole step: the program's ``ser#graph.replay`` host
records over the slice's steps. 0 where the steps ran eagerly; None without
a slice."""


def read(run):
    if run.trace is None or not run.slice_shapes:
        return None
    replays = sum(1 for name, _, _ in run.trace.host if name == "ser#graph.replay")
    return 100.0 * replays / len(run.slice_shapes)
