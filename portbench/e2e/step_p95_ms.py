"""step_p95_ms: the 95th percentile of every step's wall time in the window."""

import statistics


def value(window: dict) -> float:
    return 1e3 * statistics.quantiles(window["step_s"], n=100, method="inclusive")[94]
