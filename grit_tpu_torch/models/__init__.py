"""Model modules (reference torch parameter names)."""
