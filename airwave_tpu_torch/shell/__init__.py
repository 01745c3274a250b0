"""The serving shell: render server, wire client, load generator, CLI."""
