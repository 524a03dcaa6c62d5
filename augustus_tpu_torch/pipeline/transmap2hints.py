"""transMap2hints — transMap/genePred-style alignments to hints.

Line-faithful port of scripts/transMap2hints.pl (verified by diffing
against the Perl script itself on synthetic inputs): per record
(name, chrom, strand, txStart, txEnd, cdsStart, cdsEnd, exonCount,
exonStarts, exonEnds, ..., leftCmpl, rightCmpl, frames, hasIntrons)
emit start/stop (when the CDS end is internal and 'cmpl'), tss/tts,
fuzzy exonpart hints (a score-2 core with ep_margin trimmed, score-1
edge pieces down to ep_cutoff, split at the CDS boundaries into
UTRpart/CDSpart/exonpart), intron hints for gaps >= min_intron_len
(min_intron_len_utr outside the CDS), UTR-intron splice-site hints and
intronpart intervals.  Hints are flushed when the target sequence
changes; the original's quirks (per-iteration flush of the pending
exonpart run, the last block skipping the adjustment branch when
hasIntrons has exonCount-1 entries, signal-hint 2-deep duplicate check)
are preserved.

Host copy of `augustus_tpu/pipeline/transmap2hints.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

import sys
from typing import Dict, TextIO

DEFAULTS = dict(ep_cutoff=1, ep_margin=18, utrend_cutoff=15, ip_cutoff=0,
                min_intron_len=50, min_intron_len_utr=80,
                start_stop_radius=15, tss_tts_radius=100,
                max_intronpart_len=200000, min_exon_len=3,
                priority=4, source="T")
PRGNAME = "t2h"


class TransMap2Hints:
    def __init__(self, out: TextIO, keepids=None, **kw):
        self.p = dict(DEFAULTS)
        self.p.update(kw)
        self.out = out
        self.keepids = keepids
        self.lists: Dict[str, list] = {k: [] for k in (
            "tss", "start", "stop", "tts", "ass", "dss", "exonpart",
            "exon", "intron", "intronpart", "CDSpart", "UTRpart")}
        self.oldtarget = "no name yet"

    # ---- list insertion (mirrors the perl helpers) --------------------
    def _signal(self, key: str, hint) -> None:
        lst = self.lists[key]
        begin, strand = hint[0], hint[2]
        if not lst:
            lst.append(hint)
            return
        k = len(lst) - 1
        while k >= 0 and lst[k][0] >= begin:
            k -= 1
        dup = (k + 1 <= len(lst) - 1 and lst[k + 1][0] == begin and
               lst[k + 1][2] == strand) or \
              (k + 2 <= len(lst) - 1 and lst[k + 2][0] == begin and
               lst[k + 2][2] == strand)
        if not dup:
            lst.insert(k + 1, hint)

    def _interval(self, key: str, hint) -> None:
        self.lists[key].append(hint)

    def _exonpart(self, hint, cds_start, cds_end) -> None:
        begin, end = hint[0], hint[1]
        if end < cds_start or begin > cds_end:
            key = "UTRpart"
        elif begin >= cds_start and end <= cds_end:
            key = "CDSpart"
        else:
            key = "exonpart"
        lst = self.lists[key]
        k = len(lst) - 1
        while k >= 0 and lst[k][0] > begin:
            k -= 1
        lst.insert(k + 1, hint)

    def _fuzzy(self, begin, end, strand, qname, cds_start, cds_end):
        if begin > end:
            return
        p = self.p
        fb, fe = begin + p["ep_cutoff"], end - p["ep_cutoff"]
        cb, ce = begin + p["ep_margin"], end - p["ep_margin"]
        if cb > ce:
            cb = ce = (cb + ce) // 2
        self._exonpart([cb, ce, strand, qname, 2], cds_start, cds_end)
        if fb < cb:
            self._exonpart([fb, cb - 1, strand, qname, 1],
                           cds_start, cds_end)
        if fe > ce:
            self._exonpart([ce + 1, fe, strand, qname, 1],
                           cds_start, cds_end)

    def _fuzzy_split(self, begin, end, strand, qname, cds_start, cds_end):
        if end - begin + 1 < self.p["min_exon_len"]:
            return
        if begin < cds_start <= end:
            self._fuzzy(begin, cds_start - 1, strand, qname,
                        cds_start, cds_end)
            begin = cds_start
        if begin <= cds_end < end:
            self._fuzzy(begin, cds_end, strand, qname,
                        cds_start, cds_end)
            begin = cds_end + 1
        self._fuzzy(begin, end, strand, qname, cds_start, cds_end)

    # ---- output -------------------------------------------------------
    def flush(self) -> None:
        p = self.p
        w = self.out.write
        t = self.oldtarget
        for key, frame in (("tss", "0"), ("start", "0"), ("stop", "0"),
                           ("tts", "0"), ("ass", "."), ("dss", ".")):
            for h in self.lists[key]:
                w(f"{t}\t{PRGNAME}\t{key}\t{h[0]}\t{h[1]}\t0\t{h[2]}\t"
                  f"{frame}\tgrp={h[3]};src={p['source']};"
                  f"pri={p['priority']}\n")
        for h in self.lists["exonpart"]:
            w(f"{t}\t{PRGNAME}\texonpart\t{h[0]}\t{h[1]}\t{h[4]}\t{h[2]}"
              f"\t.\tgrp={h[3]};src={p['source']};pri={p['priority']}\n")
        for h in self.lists["exon"]:
            w(f"{t}\t{PRGNAME}\texon\t{h[0]}\t{h[1]}\t0\t{h[2]}\t.\t"
              f"grp={h[3]};src={p['source']};pri={p['priority']}\n")
        for h in self.lists["intron"]:
            w(f"{t}\t{PRGNAME}\tintron\t{h[0]}\t{h[1]}\t0\t{h[2]}\t.\t"
              f"grp={h[3]};src={p['source']};pri={p['priority']}\n")
        for key in ("CDSpart", "UTRpart"):
            for h in self.lists[key]:
                w(f"{t}\t{PRGNAME}\t{key}\t{h[0]}\t{h[1]}\t{h[4]}\t"
                  f"{h[2]}\t.\tgrp={h[3]};src={p['source']};"
                  f"pri={p['priority']}\n")
        for lst in self.lists.values():
            lst.clear()

    # ---- main ---------------------------------------------------------
    def run(self, lines) -> None:
        p = self.p
        for raw in lines:
            line = raw.split("#")[0]
            if not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 15:
                continue
            qname, target, strand = f[0], f[1], f[2]
            tx_start, tx_end = int(f[3]), int(f[4])
            cds_start, cds_end = int(f[5]), int(f[6])
            exonstarts = f[8].rstrip(", ")
            exonends = f[9].rstrip(", ")
            leftcmpl, rightcmpl = f[12], f[13]
            has_introns = f[15].rstrip(", ") if len(f) > 15 else ""
            if self.keepids is not None:
                base = qname.rsplit("-", 1)[0] \
                    if qname.rsplit("-", 1)[-1].isdigit() else qname
                if base not in self.keepids:
                    continue
            if target != self.oldtarget:
                self.flush()
            s = [int(x) for x in exonstarts.split(",") if x != ""]
            e = [int(x) for x in exonends.split(",") if x != ""]
            if has_introns:
                inf = [int(x) for x in has_introns.split(",")]
            else:
                inf = [1] * (len(s) - 1)
            nb = len(s)
            ssr, ttr = p["start_stop_radius"], p["tss_tts_radius"]
            # NB: the reference compares $leftcmpl == 'cmpl' NUMERICALLY
            # (both sides numify to 0), so the completeness check always
            # passes for cmpl/incmpl values — quirk preserved
            del leftcmpl, rightcmpl
            if strand == "+":
                if tx_start != cds_start and cds_start > 0:
                    self._signal("start", [cds_start + 1 - ssr,
                                           cds_start + 3 + ssr, "+",
                                           qname])
                if tx_end != cds_end and cds_end > 0:
                    self._signal("stop", [cds_end - 2 - ssr,
                                          cds_end + ssr, "+", qname])
            else:
                if tx_start != cds_start and cds_start > 0:
                    self._signal("stop", [cds_start + 1 - ssr,
                                          cds_start + 3 + ssr, "-",
                                          qname])
                if tx_end != cds_end and cds_end > 0:
                    self._signal("start", [cds_end - 2 - ssr,
                                           cds_end + ssr, "-", qname])
            if strand == "+":
                if tx_start != cds_start and tx_start > 0:
                    self._signal("tss", [tx_start + 1 - ttr,
                                         tx_start + 1 + ttr, "+", qname])
                if tx_end != cds_end and tx_end > 0:
                    self._signal("tts", [tx_end - ttr, tx_end + ttr,
                                         "+", qname])
            else:
                if tx_start != cds_start and tx_start > 0:
                    self._signal("tts", [tx_start + 1 - ttr,
                                         tx_start + 1 + ttr, "-", qname])
                if tx_end != cds_end and tx_end > 0:
                    self._signal("tss", [tx_end - ttr, tx_end + ttr,
                                         "-", qname])

            epb = epe = -1
            frm = to = 0
            for i in range(nb):
                frm = s[i] + 1
                to = e[i]
                in_i = inf[i] if i < len(inf) else None
                if in_i == 1:
                    if i == 0:
                        if frm + p["utrend_cutoff"] <= to:
                            frm += p["utrend_cutoff"]
                        else:
                            frm = to
                        if frm > cds_start >= tx_start:
                            frm = cds_start
                    if i == nb - 1:
                        if to - p["utrend_cutoff"] >= frm:
                            to -= p["utrend_cutoff"]
                        else:
                            to = frm
                        if to < cds_end <= tx_end:
                            to = cds_end
                    if epb < 0 or epe < 0:
                        epb, epe = frm, to
                    elif ((epe < cds_start or epb > cds_end) and
                          epe + p["min_intron_len_utr"] + 1 >= frm) or \
                            epe + p["min_intron_len"] + 1 >= frm:
                        epe = to
                    else:               # large gap
                        ifrom, ito = epe + 1, frm - 1
                        if ito - ifrom + 1 >= p["min_intron_len"] and \
                                (i >= 1 and i - 1 < len(inf)
                                 and inf[i - 1]):
                            self._interval("intron",
                                           [ifrom, ito, strand, qname])
                            if ifrom < cds_start or ifrom > cds_end:
                                key = "dss" if strand == "+" else "ass"
                                self._signal(key, [ifrom, ifrom, strand,
                                                   qname])
                            if ito < cds_start or ito > cds_end:
                                key = "ass" if strand == "+" else "dss"
                                self._signal(key, [ito, ito, strand,
                                                   qname])
                            ifrom += p["ip_cutoff"]
                            ito -= p["ip_cutoff"]
                            if ifrom < ito and ifrom > cds_start and \
                                    ito < cds_end and ito - ifrom + 1 \
                                    <= p["max_intronpart_len"]:
                                self._interval("intronpart",
                                               [ifrom, ito, strand,
                                                qname])
                        self._fuzzy_split(epb, epe, strand, qname,
                                          cds_start, cds_end)
                        epb, epe = frm, to
                # per-iteration flush of the pending run (original quirk)
                self._fuzzy_split(epb, epe, strand, qname,
                                  cds_start, cds_end)
                epb, epe = frm, to
                self.oldtarget = target
        self.flush()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    inp = out = None
    kw = {}
    keepids = None
    for a in argv:
        if a.startswith("--in="):
            inp = a.split("=", 1)[1]
        elif a.startswith("--out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--keepids="):
            keepids = set(l.strip() for l in open(a.split("=", 1)[1]))
        elif a.startswith("--priority="):
            kw["priority"] = int(a.split("=", 1)[1])
        elif a.startswith("--source="):
            kw["source"] = a.split("=", 1)[1]
        elif "=" in a and a.startswith("--"):
            k, v = a[2:].split("=", 1)
            if k in DEFAULTS:
                kw[k] = int(v)
    if inp is None:
        sys.stderr.write("usage: transmap2hints --in=transmap.gp "
                         "--out=hints.gff [options]\n")
        return 1
    fh_out = open(out, "w") if out else sys.stdout
    TransMap2Hints(fh_out, keepids=keepids, **kw).run(open(inp))
    if out:
        fh_out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
