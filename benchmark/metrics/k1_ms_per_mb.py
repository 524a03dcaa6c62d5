"""The Viterbi kernel K1 (stage `kernel`: CUDA events around its launches,
cut-point exams included), ms per decoded Mb."""


def read(r):
    t = r.times.get("kernel")
    return None if t is None or not r.bases else t * 1e3 / r.mb
