"""The share of the window's time in which no operation ran on the card:
100 % less the device's busy time a unit (the union of the device rows'
spans of the traced units, each issued when the last had completed, as
in the window; averaged over the ranks) over the window's time a unit
(its whole time over its units). The work of a unit on the card is the
same traced or not; its time is not: the profiler's cost on each launch
slows a loop that the host paces, so the traced units' own idle share
(``device.busy_s`` / ``device.window_s``) reads higher than the
window's. Where a traced unit's busy time exceeds the window's unit time
(on several chips, a collective's kernel waiting for a rank that the
profiler slowed), the reading goes below 0 and says so."""


def read(ctx):
    s, w = ctx["summary"], ctx["window"]
    if ctx["mode"] != "train" or not s or s["busy_s"] <= 0 or not w["units"]:
        return None
    busy_s = s["busy_s"] / s["units"]
    return 100.0 * (1.0 - busy_s / (w["seconds"] / w["units"]))
