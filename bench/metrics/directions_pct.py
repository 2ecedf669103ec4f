"""directions_pct (ProHD selection): the device time of ProHD's directions
(the centroid axis, the clouds' concatenation, the Gram SGEMM and
``eigh``) over the traced calls' time.  It sums the ``device_s`` of the
program's ``hd.prohd.directions`` spans: the seconds from the stream
reaching a span's start event to its reaching the end event.  Nothing to
read where the program has no such span or ran off the card (no
``device_s``)."""

SPAN = "hd.prohd.directions"


def read(view) -> float | None:
    times = [s.get("device_s") for s in view.spans if s.get("type") == "span" and s["name"] == SPAN]
    if not times or any(t is None for t in times):
        return None
    return 100.0 * sum(times) / view.calls_s()
