"""Entry points of the port (``serve_embed``)."""
