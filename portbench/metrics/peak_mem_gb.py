"""The card's peak of allocated memory over the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
its start), in GB (1e9 bytes)."""


def read(ctx):
    return ctx.peak_bytes / 1e9
