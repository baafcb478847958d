"""Caption evaluation."""
