"""Padded image batches."""
