"""Model layers of the port: the sparse-weight linear layer."""
