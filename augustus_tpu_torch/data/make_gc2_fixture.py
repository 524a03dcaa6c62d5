"""Write the two-GC-class species fixture ``repo_fixture_gc2``.

It holds the data of ``repo_fixture`` with every per-GC-class block of the
three parameter files duplicated as class ``[2]`` and perturbed
deterministically: each number on a pattern line (``acgt... value ...``) and
the intron ``[TRANSITION]`` numbers are scaled by a factor in [0.85, 1.15]
that depends only on its position in the block.  Together with
``/BaseCount/weighingType 2`` and a short ``GCwinsize`` this gives sequences
a class switch every few kilobases.

Run from the repository root:  python3 augustus_tpu_torch/data/make_gc2_fixture.py
"""

from __future__ import annotations

import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "config", "species", "repo_fixture")
DST = os.path.join(HERE, "config", "species", "repo_fixture_gc2")

_PATTERN_LINE = re.compile(r"^([acgtACGT]+)(\s.*)$")
_NUMBER = re.compile(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?")

PARAMETERS = """\
# Species parameters of the two-GC-class fixture "repo_fixture_gc2".
# Written by augustus_tpu_torch/data/make_gc2_fixture.py from repo_fixture.
/Constant/trans_init_window     20
/Constant/ass_upwindow_size     30
/Constant/ass_start             3
/Constant/ass_end               2
/Constant/dss_start             3
/Constant/dss_end               4
/Constant/init_coding_len       15
/Constant/intterm_coding_len    5
/Constant/decomp_num_steps      2
/Constant/min_coding_len        201
/BaseCount/weighingType         2
GCwinsize                       1200
/ExonModel/k                    4
/ExonModel/maxexonlength        15000
/ExonModel/minexonlength        1
/IntronModel/minintronlen       39
"""


def _factor(i: int) -> float:
    return 1.0 + 0.15 * (((i * 7919) % 13) - 6) / 6.0


def _perturb_numbers(text: str, counter: list) -> str:
    def sub(m):
        counter[0] += 1
        return "%.6g" % (float(m.group(0)) * _factor(counter[0]))
    return _NUMBER.sub(sub, text)


def perturb_block(block: str) -> str:
    out = []
    counter = [0]
    in_transition = False
    for line in block.split("\n"):
        stripped = line.strip()
        if stripped.startswith("["):
            in_transition = stripped == "[TRANSITION]"
            out.append(line)
            continue
        m = _PATTERN_LINE.match(stripped)
        if m:
            out.append(m.group(1) + _perturb_numbers(m.group(2), counter))
        elif in_transition and stripped and not stripped.startswith("#"):
            out.append(_perturb_numbers(line, counter))
        else:
            out.append(line)
    return "\n".join(out)


def main() -> None:
    os.makedirs(DST, exist_ok=True)
    for model in ("igenic", "exon", "intron"):
        with open(os.path.join(SRC, f"repo_fixture_{model}_probs.pbl")) as fh:
            text = fh.read()
        head, sep, block = text.partition("[1]")
        if not sep:
            raise ValueError(f"{model}: no [1] block")
        two = head + "[1]" + block.rstrip("\n") + "\n[2]" + \
            perturb_block(block).rstrip("\n") + "\n"
        with open(os.path.join(DST, f"repo_fixture_gc2_{model}_probs.pbl"),
                  "w") as fh:
            fh.write(two)
    with open(os.path.join(DST, "repo_fixture_gc2_parameters.cfg"), "w") as fh:
        fh.write(PARAMETERS)


if __name__ == "__main__":
    main()
