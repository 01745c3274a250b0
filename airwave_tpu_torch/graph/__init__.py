"""Renderer preparation and the live EQ runtime."""
