"""The LM scaffolding of the port: layers and the dense transformer."""
