"""Training loops of the port: the classic (paper-experiment) runner."""
