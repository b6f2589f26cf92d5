"""Grid search over configs."""
