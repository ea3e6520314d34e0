"""The attention transformer (models/transformer.py) and its encoder
families (models/encoders.py), over parameter trees of tensors."""
