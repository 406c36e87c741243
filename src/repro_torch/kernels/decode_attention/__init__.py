"""Split-K one-token decode attention over a ring-buffer cache (kernel 10)."""
