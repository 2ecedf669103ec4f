"""Architecture configs of the port (the dense LMs) and their registry."""
