"""peak_mem_gib: torch.cuda.max_memory_allocated() over set-up and the
window, in GiB: the largest scene a user can fit on the card."""


def read(ctx):
    return ctx["memory_peak_bytes"] / 2.0 ** 30
