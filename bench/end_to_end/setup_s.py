"""setup_s: from the process's start to the first timed call: imports, the
card's start, the kernels' build or load, the inputs, the store, warm-up."""


def read(window: dict) -> float:
    return window["setup_s"]
