"""Core SCAR library of the port: iteration-cost theory, block partition,
norms, the running checkpoint, recovery, perturbations and the
fault-tolerance controller (see :mod:`repro.core` for the reference)."""
