"""State export and evaluation metrics."""
