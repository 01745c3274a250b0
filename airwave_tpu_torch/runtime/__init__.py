"""The multi-stream serving pool."""
