"""Beam search (KV-cached and fixed-buffer), shallow fusion of the neural
LM, and n-best output; the hybrid AM's search over an HLG graph on the
host (latgen), its word lattices (lattice_io, lattice_ops), confusion
networks and ROVER (confusion), posterior best paths (best_path) and
forced alignment (align)."""
