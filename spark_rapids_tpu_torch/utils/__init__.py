"""Shared helpers of the port (``locks``: the declared lock order)."""
