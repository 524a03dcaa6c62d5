"""The traceback (stage `traceback`: the cummax table and the event walk
K4, CUDA events), ms per decoded Mb."""


def read(r):
    t = r.times.get("traceback")
    return None if t is None or not r.bases else t * 1e3 / r.mb
