"""Pieces in flight on one card (`mesh`) and across processes
(`distributed`): the port's counterpart of `augustus_tpu/parallel`."""
