"""Entry points of the port: ``train`` (LM training end to end)."""
