"""peak_mem_mib: torch.cuda.max_memory_allocated() at the window's end, set-up included."""


def value(window: dict) -> float:
    return window["peak_bytes"] / 2**20
