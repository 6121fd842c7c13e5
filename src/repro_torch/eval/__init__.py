"""Evaluation of the port (``extraction`` for serving so far)."""
