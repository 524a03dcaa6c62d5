"""Supervised training (etraining equivalent) of the port: GenBank-annotated
sequences in, species .pbl parameter files out (reference src/etraining.cc,
src/exontrain.cc, src/introntrain.cc, src/igenictrain.cc, src/utrtrain.cc),
then, with --CRF=on, discriminative rounds that predict every training gene
on the card (training/crf.py).  Port of `augustus_tpu/training`; the counting
and the files are host numpy and byte-equal to it."""
