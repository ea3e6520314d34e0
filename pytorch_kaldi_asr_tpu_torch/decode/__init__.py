"""Beam search and n-best output (the KV-cached search of the recipe)."""
