"""Training-side structures of the port: the GenBank annotation of
io/genbank.py.  The training modules of augustus_tpu/training are not ported
yet."""
