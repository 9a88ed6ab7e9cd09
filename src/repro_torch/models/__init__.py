"""Parameter specs, layers, attention, blocks and the model facade."""
