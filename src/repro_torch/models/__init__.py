"""Models of the port: LM layers and the transformer, GAT, the recsys zoo, embeddings and retrieval."""
