"""Deep GP models."""
