"""Vocabulary control-symbol constants.

Mirrors the reference's reserved ids and symbol spellings
(reference: pytorch/utils/constants.py:1-11) so that vocab files, label id
sequences, and decode outputs are interchangeable between the two frameworks.
"""

PAD = 0
UNK = 1
BOS = 2
EOS = 3

PAD_WORD = "<blank>"
UNK_WORD = "<unk>"
BOS_WORD = "<s>"
EOS_WORD = "</s>"

# The recipe appends a single disambiguation symbol after vocab build
# (reference: run.sh:52-53); tooling that must round-trip vocab files needs
# to know its spelling.
DISAMBIG_WORD = "#0"
