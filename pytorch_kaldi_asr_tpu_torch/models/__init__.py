"""The attention transformer (models/transformer.py), its encoder families
(models/encoders.py) and the neural LM (models/nlm.py), over parameter
trees of tensors."""
