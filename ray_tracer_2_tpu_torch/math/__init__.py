"""Vector helpers on tensors and numpy host transforms."""
