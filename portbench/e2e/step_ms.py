"""step_ms: the window's wall time over the steps completed in it."""


def value(window: dict) -> float:
    return 1e3 * window["wall_s"] / len(window["step_s"])
