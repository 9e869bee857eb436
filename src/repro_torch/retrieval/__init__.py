"""Retrieval side: corpus encoder, KB containers, backends, retrievers."""
