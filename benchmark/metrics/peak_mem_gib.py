"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start, in GiB."""


def read(out):
    return out["peak_window"] / 2 ** 30
