"""Synthetic data generators (numpy; shared seeds with the reference)."""
