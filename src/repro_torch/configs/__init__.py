"""Architecture configs of the port (the LMs, GAT and the recsys models) and their registry."""
