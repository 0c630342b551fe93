"""Command entry points of the port."""
