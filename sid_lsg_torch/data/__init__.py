"""Training inputs of the port: the prompt corpus."""
