"""The bytes that PyTorch's caching allocator held free (reserved and not
allocated) when `parallel/mesh.decode_pieces` read its memory budget,
which the budget does not count: the largest over the window's cut
records (`decode_pieces.last["cached_free_bytes"]`), GB; None when no
record was cut."""


def read(r):
    got = [p["cached_free_bytes"] for p in r.pieces
           if "cached_free_bytes" in p]
    return max(got) / 1e9 if got else None
