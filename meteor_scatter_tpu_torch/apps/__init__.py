"""Command-line applications of the port."""
