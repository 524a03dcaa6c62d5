"""The share of the traced window in which no kernel, copy or memset ran
on the card (torch.profiler's device events)."""


def read(r):
    p = r.profile
    if p is None or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
