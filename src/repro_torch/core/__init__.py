"""Loss layer of the port (``losses``)."""
