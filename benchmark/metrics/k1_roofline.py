"""K1's share of its roofline: the least time that the bytes and
operations of the decoded records' recursion allow at the H100's
published peaks (benchlib.work, benchlib.peaks), over K1's event time.
The work counts each record's letters once: the cut-point exams' launches
add to the time and not to the work."""

from benchlib.peaks import least_seconds


def read(r):
    t = r.times.get("kernel")
    if not t or not r.work_bytes:
        return None
    return 100.0 * least_seconds(r.work_ops, r.work_bytes) / t
