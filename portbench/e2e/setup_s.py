"""setup_s: from the process's start to the first timed step."""


def value(window: dict) -> float:
    return window["setup_s"]
