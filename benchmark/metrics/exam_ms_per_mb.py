"""The cut-point exams (stage `exam`, host clock: each 150 kb exam's
preparation, single K1 launch and walk, from `predict._next_cut_end_point`),
ms per decoded Mb."""


def read(r):
    t = r.times.get("exam")
    return None if t is None or not r.bases else t * 1e3 / r.mb
