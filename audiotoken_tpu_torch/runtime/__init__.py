"""Runtime: shape bucketing, the precision policy, stage timers and trace
capture."""
