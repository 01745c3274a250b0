"""Render-chain ops on torch tensors, plus the host-side numpy filter design."""
