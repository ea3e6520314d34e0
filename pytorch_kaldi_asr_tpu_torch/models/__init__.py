"""The attention transformer (models/transformer.py), its encoder families
(models/encoders.py), the neural LM (models/nlm.py) and the hybrid
acoustic model (models/am.py), over parameter trees of tensors."""
