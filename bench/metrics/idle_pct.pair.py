"""idle_pct.pair (device): the share of the traced window (the first call's
start to the last call's end) in which no operation ran on the card."""


def read(view) -> float | None:
    return view.idle_pct()
