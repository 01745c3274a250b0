"""Float64 reference implementations used on the host."""
