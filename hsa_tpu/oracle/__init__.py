"""Ground-truth CPU oracle for output parity (SURVEY.md §4.1).

The reference mount is empty, so the parity oracle is this direct
implementation of the BWA-0.5.x-lineage branch-and-bound semantics
documented in SURVEY.md Appendix A.  The device engines must produce
record-equal results (positions, strand, edit ops) to this oracle.
"""
