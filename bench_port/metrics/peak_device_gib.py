"""``peak_device_gib``: the most device memory allocated in the window
above what was allocated at its start (the inputs and the entry's
state): ``torch.cuda.max_memory_allocated()`` after
``reset_peak_memory_stats()``, less ``memory_allocated()`` then; GiB."""

def read(ctx: dict):
    return ctx["peak_bytes_above_inputs"] / 2**30
