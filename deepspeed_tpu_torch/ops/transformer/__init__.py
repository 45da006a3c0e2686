"""Transformer operators: paged decode attention, flash attention and fused
linear cross-entropy, each with its plain version."""
