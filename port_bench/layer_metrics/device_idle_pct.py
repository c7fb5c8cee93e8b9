"""The share of the traced window in which no operation ran on the card, the
largest over the ranks. One quantity, split by the end-to-end metric it
moves (``device_idle_pct.render``, ``device_idle_pct.train``)."""


def read(run):
    if not run.traces or run.window_s <= 0 or not any(t["ops"] for t in run.traces):
        return None
    return max(100.0 * (1.0 - t["busy_s"] / t["window_s"]) for t in run.traces)
