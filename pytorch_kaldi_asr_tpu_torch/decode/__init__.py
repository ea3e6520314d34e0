"""Beam search (KV-cached and fixed-buffer), shallow fusion of the neural
LM, and n-best output; the hybrid AM's search over an HLG graph on the
host (latgen) and forced alignment (align)."""
