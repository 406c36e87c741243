"""Blockwise causal / sliding-window prefill attention (kernel 11)."""
