"""Frame construction and projection matching."""
