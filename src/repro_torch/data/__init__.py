"""Data generators of the port."""
