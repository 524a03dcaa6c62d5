"""PPX — protein profile extension (reference src/pp_*.cc).

Block-profile representation of a protein family plus the search tools:
`.prfl` parsing and scoring (profile.py, vs src/pp_profile.cc), the fast
block pre-filter (fastblock.py, vs src/pp_fastBlockSearcher.cc +
src/fastBlockSearch.cc) and the profile/protein similarity DP
(simscore.py, vs src/pp_simscore.cc).

Port of `augustus_tpu/ppx/`: host copies of its modules (numpy and the
standard library); none of them runs a kernel.
"""
