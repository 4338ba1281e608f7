"""Training: optimizer, synthetic data and the FSDP train step."""
