"""Beam search (KV-cached and fixed-buffer), shallow fusion of the neural
LM, and n-best output."""
