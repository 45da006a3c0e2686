"""Transformer operators: paged decode attention and its plain version."""
