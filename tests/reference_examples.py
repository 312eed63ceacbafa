"""Runs the reference's example scripts (``examples/<name>.py``) in this
process for the tests of their ports: what each prints, and the random
block ids each reference ``FTController`` drew while it ran."""
import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np

from repro.core.controller import FTController as JController
from repro.core.policy import SelectionStrategy as JStrategy

ROOT = Path(__file__).resolve().parents[1]


def reference_output(name: str, argv=()) -> tuple[str, list]:
    """What ``examples/<name>.py``'s ``main()`` prints, run here, and the
    block ids each reference ``FTController`` it built drew from its key,
    in order (its uniform failure and its RANDOM-strategy saves): one list
    a controller, in the order the script built them."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    runs = []
    init, sample = JController.__init__, JController.sample_failure

    def recording_init(self, *args, **kw):
        init(self, *args, **kw)
        drawn = []
        runs.append(drawn)
        select = self._jit_select

        def recording_select(*a, **k):
            mask, cursor = select(*a, **k)
            if self.policy.strategy == JStrategy.RANDOM:
                drawn.append(np.nonzero(np.asarray(mask))[0])
            return mask, cursor
        self._jit_select = recording_select
        self._drawn = drawn

    def recording_sample(self, fraction):
        mask = sample(self, fraction)
        self._drawn.append(np.nonzero(np.asarray(mask))[0])
        return mask

    out = io.StringIO()
    old = sys.argv
    sys.argv = [f"{name}.py", *argv]
    JController.__init__ = recording_init
    JController.sample_failure = recording_sample
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = old
        JController.__init__, JController.sample_failure = init, sample
    return out.getvalue(), runs


def find(pattern: str, text: str):
    m = re.search(pattern, text)
    assert m, f"{pattern!r} not in the reference's output"
    return m.groups()
