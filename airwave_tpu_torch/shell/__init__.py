"""The serving shell: render server, wire client, load generator, CLI, and
the status presentation and launch policies."""
