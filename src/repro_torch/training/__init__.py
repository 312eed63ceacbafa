"""Training loops of the port: the classic (paper-experiment) runner and
the LM server (``serve.Server``)."""
