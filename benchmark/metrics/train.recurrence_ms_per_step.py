"""Host ms a train step of the program's ``ser#recurrence`` span in the
traced slice: the model's Python loop over the utterances in an eager
step's forward (DialogueRNN's ``models/dialogue_rnn.py::recurrence``, both
directions stacked). None where the slice holds no such span (a replayed
step, or a program without the span)."""

from benchmark.metrics.spans import host_ms_per_item


def read(run):
    return host_ms_per_item(run, "ser#recurrence")
