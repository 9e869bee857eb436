"""Synthetic corpus for the retrieval stack."""
