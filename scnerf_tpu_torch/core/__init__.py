"""The experiment config and small imaging utilities."""
