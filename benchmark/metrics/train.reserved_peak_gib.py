"""GiB the allocator held from the card at most, from the window's opening
to the end of the traced slice (``torch.cuda.max_memory_reserved``, reset
with ``train_peak_gib``'s allocated peak): the cache and the CUDA graphs'
private pools, which the allocated peak does not count. None off the card."""


def read(run):
    if run.reserved_peak_bytes is None:
        return None
    return run.reserved_peak_bytes / 2 ** 30
