"""Pipeline layer: the reference's scripts/ ecosystem as a Python package.

Reference: scripts/*.pl (113 Perl/Python scripts, ~24 kLoC) — cluster
chunking (splitMfasta.pl, createAugustusJoblist.pl, join_aug_pred.pl),
hint generation (blat2hints.pl, wig2hints.pl, join_mult_hints.pl),
training-set preparation (gff2gbSmallDNA.pl, randomSplit.pl), format
conversion (gtf2gff.pl, getAnnoFasta.pl) and metaparameter optimization
(optimize_augustus.pl).  Each module here reimplements one family with
the same file formats, exposed under
python -m augustus_tpu_torch.pipeline.<x>.

Port of `augustus_tpu/pipeline/`: host copies of its modules (numpy and the
standard library).  Only optimize.py reaches the card, through training
(training/etraining.py) and GenBank evaluation (predict.evaluate_genbank).
"""
