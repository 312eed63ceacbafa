"""Models of the port: the paper's classic iterative-convergent models."""
