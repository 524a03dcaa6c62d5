"""Gene projection and GFF printing (stages `project` and `print`, host
clock), ms per decoded Mb."""


def read(r):
    t = [r.times[k] for k in ("project", "print") if k in r.times]
    return None if not t or not r.bases else sum(t) * 1e3 / r.mb
