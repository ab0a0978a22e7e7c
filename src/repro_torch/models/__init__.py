"""Model definitions (dense decoder family)."""
