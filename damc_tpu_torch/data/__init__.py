"""Training data feeds of the port."""
