"""Tree utilities shared across the port."""
