"""C++ iostream-compatible number formatting for .pbl parameter files.

The reference writes Double (LLDouble) values through operator<< with a
static output precision (src/lldouble.cc:77 toString); for values inside the
double range this is exactly C++ ostream default-format printing, which
Python's ``%g`` reproduces (both use correctly-rounded shortest conversion of
the same IEEE double).

Port of `augustus_tpu/training/fmt.py`: host Python, no kernel.
"""

from __future__ import annotations


def g(x: float, precision: int = 3) -> str:
    """C++ ``ostream << double`` with the given precision (default format).

    %g prints exponents with at least 2 digits and explicit sign
    ("1e+06", "2.65e-05"), matching C++ iostreams.
    """
    return "%.*g" % (precision, x)


def seq_inv(pn: int, size: int, upper: bool = False) -> str:
    """Pattern index -> base string (reference Seq2Int::inv/INV)."""
    bases = "ACGT" if upper else "acgt"
    out = []
    for _ in range(size):
        out.append(bases[pn % 4])
        pn >>= 2
    return "".join(reversed(out))


def setw(s: str, w: int) -> str:
    """C++ setw right-justification (space fill)."""
    return s.rjust(w)
