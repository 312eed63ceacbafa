"""PyTorch and CUDA port of the SCAR reproduction (``repro``).

The package mirrors ``repro``'s layout: ``core/`` (policies, blocks,
norms, the iteration-cost theory, the running checkpoint, recovery,
perturbations and the fault-tolerance controller), ``checkpoint_io/`` (the
disk store), ``data/``, ``models/``, ``training/``, ``telemetry/``,
``examples/`` and ``kernels/<name>/{kernel,ref,ops}.py`` with the CUDA
sources under ``csrc/``. It imports torch, numpy, scipy and the standard
library only.

Entry points (``make_model``, ``FTController``, ``ShardedCheckpointStore``,
the runners) run on the card unless the caller passes ``device="cpu"``.
"""
