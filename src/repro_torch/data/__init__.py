"""Deterministic, resumable training data."""
