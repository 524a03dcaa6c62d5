"""Cut-point exams per cut (counters `exams` and `cuts` of
`predict.cut_pieces`): 1 when every first exam finds its cut, 2 when every
cut takes the second, doubled exam; None without cuts."""


def read(r):
    exams, cuts = r.counts.get("exams"), r.counts.get("cuts")
    return None if exams is None or not cuts else exams / cuts
