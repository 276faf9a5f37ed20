"""Runtime: shape bucketing and the precision policy."""
