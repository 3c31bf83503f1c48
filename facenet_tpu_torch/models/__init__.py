"""Embedding networks of the port."""
