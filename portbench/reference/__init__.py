"""The plain references, one a configuration."""
