"""Training: the AdamW optimizer, the train and eval steps, and the
metrics logger (counterpart of repro/train)."""
