"""The plain reference: a window of a record decoded by `augref`.

`benchmark/augref` is a frozen copy of the Python modules that the
program runs on the CPU (its plain PyTorch and NumPy versions of every
kernel), taken when its CPU path printed `augustus_tpu`'s GFF byte for
byte.  It imports nothing of the program.  It reads the configuration's
files and the cell's hints file itself.

A window [a, b] of a record is decoded as a piece that ends in the synch
(intergenic) state, and starts in it unless it starts the record, the way
the program decodes the pieces of a long sequence.  Where the program's
path is intergenic at b (and at a), the best path with those ends is the
program's path there: the window's genes must be the program's, line for
line.  `control="bf16"` rounds every float plane of the Viterbi
recursion to bfloat16 before it runs (the precision below the float32
that the configuration states).
"""

from __future__ import annotations

from typing import Dict, List, Optional

_MODELS: Dict[tuple, object] = {}


def _model(config_path: str, options: Dict[str, str],
           hints_path: Optional[str]):
    from augref import predict
    key = (config_path, tuple(sorted(options.items())), hints_path)
    if key not in _MODELS:
        args = dict(options)
        if hints_path is not None:
            args["hintsfile"] = hints_path
        _MODELS[key] = predict.Model.load(args, config_path)
    return _MODELS[key]


def _bf16_planes(fn):
    import torch

    def rounded(static, planes, debug_vals=False):
        low = {k: (v.to(torch.bfloat16).to(v.dtype)
                   if isinstance(v, torch.Tensor) and v.is_floating_point()
                   else v) for k, v in planes.items()}
        return fn(static, low, debug_vals)
    return rounded


def init_worker() -> None:
    import torch
    torch.set_num_threads(1)


def decode_window(job: dict) -> List[str]:
    """The GFF lines of the genes that the reference finds in one window.

    job: config_path, options, hints_path, name (the record's), letters
    (the window's), begin (its 0-based start in the record), control (None
    or "bf16").  Coordinates are the window's, 1-based."""
    import torch
    from augref import genetics, predict
    from augref.engine import viterbi
    from augref.output import genes as og
    model = _model(job["config_path"], job["options"], job["hints_path"])
    plain = viterbi.viterbi_forward_reference
    if job.get("control") == "bf16":
        viterbi.viterbi_forward_reference = _bf16_planes(plain)
    try:
        seq = job["letters"]
        a = job["begin"]
        b = a + len(seq) - 1
        hints = None
        if model.gff_hints is not None:
            hints = predict._piece_hints(
                model.gff_hints.get(job["name"], []), a, b)
        codes = genetics.encode(seq.lower())
        softmask = genetics.softmask_runs(seq)
        agl, with_evidence = predict._find_genes(
            model, codes, softmask, hints, torch.device("cpu"),
            init_synch=a > 0, term_synch=True)
    finally:
        viterbi.viterbi_forward_reference = plain
    for k, ag in enumerate(agl, start=1):
        ag.id = f"g{k}"
        ag.seqname = job["name"]
        for t, tx in enumerate(ag.transcripts, start=1):
            tx.seqname = job["name"]
            tx.id = f"t{t}"
            tx.geneid = ag.id
    if not agl:
        return []
    o = og.OutputOptions.from_properties(model.props)
    text = og.print_gene_list(agl, codes, o, model.gcode,
                              with_evidence=with_evidence, seq_offset=0)
    return text.splitlines()
