"""Host hint and track preparation (stage `prep`: collect_hints,
build_overlays, the GC stairs), ms per decoded Mb."""


def read(r):
    t = r.times.get("prep")
    return None if t is None or not r.bases else t * 1e3 / r.mb
