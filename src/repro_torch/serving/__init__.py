"""Fixed-batch serving engine."""
