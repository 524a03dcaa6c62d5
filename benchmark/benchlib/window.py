"""The measured window: records sent one after another in a closed loop."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence


@dataclass
class Done:
    index: int            # into the records
    output: Optional[str]  # None when the call raised
    end_s: float          # completion, seconds after the window opened
    error: str = ""


def closed_loop(records: Sequence, seconds: float, call: Callable,
                clock: Callable[[], float] = time.perf_counter
                ) -> List[Done]:
    """Call `call(record)` on the records in turn (from the first again
    when they run out), the first at once and each further one while fewer
    than `seconds` have passed since the window opened; the call under way
    when they pass runs to its end."""
    done: List[Done] = []
    t0 = clock()
    k = 0
    while k == 0 or clock() - t0 < seconds:
        i = k % len(records)
        try:
            out, err = call(records[i]), ""
        except Exception as exc:            # a failed record is counted
            out, err = None, f"{type(exc).__name__}: {exc}"
        done.append(Done(i, out, clock() - t0, err))
        k += 1
    return done


def mb_per_s(done: List[Done], lengths: Sequence[int]) -> float:
    """Bases of the records that finished, in Mb, over the seconds from
    the window's start to the completion of the last call."""
    bases = sum(lengths[d.index] for d in done if d.output is not None)
    return bases / 1e6 / done[-1].end_s
