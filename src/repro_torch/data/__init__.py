"""Synthetic references and reads with ground truth."""
