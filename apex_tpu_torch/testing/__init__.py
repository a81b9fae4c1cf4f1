"""Entry points of the port (``standalone_gpt --serve``)."""
