"""Command-line examples of the port, run with ``python -m``."""
