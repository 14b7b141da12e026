"""Training substrate: optimizer, steps, data, checkpointing, compression."""
