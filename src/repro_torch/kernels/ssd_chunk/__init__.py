"""Mamba-2 SSD chunk scan (kernel 12)."""
