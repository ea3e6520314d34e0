"""Shared constants, logging, device selection and the checkpoint codec."""
