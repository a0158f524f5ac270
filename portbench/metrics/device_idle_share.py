"""The card's idle share of the profiled stretch (%): the wall time in which
no kernel, copy or memset ran on the device, over the stretch's length
(``trace.summarize``)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
