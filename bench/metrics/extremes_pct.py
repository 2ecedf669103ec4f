"""extremes_pct (ProHD selection): the device time of ProHD's extremes (the
projections, ``topk`` on each direction, and the packing of the selected
rows into their static capacities) over the traced calls' time: the
summed ``device_s`` of the program's ``hd.prohd.extremes`` spans.
Nothing to read where the program has no such span or ran off the card
(no ``device_s``)."""

SPAN = "hd.prohd.extremes"


def read(view) -> float | None:
    times = [s.get("device_s") for s in view.spans if s.get("type") == "span" and s["name"] == SPAN]
    if not times or any(t is None for t in times):
        return None
    return 100.0 * sum(times) / view.calls_s()
