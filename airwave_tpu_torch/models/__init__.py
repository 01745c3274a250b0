"""Model layer: the binaural render chain and the offline bake API."""
