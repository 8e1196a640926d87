"""Checkpoint files of the port: its own format and the reading half of
the reference Lightning format. The training loop is not ported yet."""
