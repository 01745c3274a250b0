"""Stream-sharded render over several devices (mesh) and processes (multihost)."""
