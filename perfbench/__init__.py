"""The port's benchmark (``run.py``) and its yardstick."""
