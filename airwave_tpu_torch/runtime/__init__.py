"""The multi-stream serving pool, and the live runtime: the controller, its
pipeline, transports and scheduler, and the profile coordinators."""
