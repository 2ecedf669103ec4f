"""pair_s: the window's wall time over the calls completed in it (each call
ended when its result was on the host)."""


def read(window: dict) -> float | None:
    done = sum(r["requests"] - r["failed"] for r in window["records"])
    if done == 0:
        return None
    return (window["end"] - window["start"]) / done
