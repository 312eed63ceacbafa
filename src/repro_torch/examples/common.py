"""What the classic examples share: the MLR workload of
``examples/quickstart.py``, on the device or fed recorded draws, and the
``--device`` flag.

``draws`` (all numpy; e.g. the reference's, carried across by a test):

- ``"batches"``: ``{(seed, i): batch indices}``, iteration ``i``'s inputs
  in a run seeded ``seed`` (``models.classic.with_draws``);
- ``"eps"`` and ``"x_star"``: the convergence target and optimum of the
  run that recorded them;
- ``"blocks"``: one list a ``run_with_failure`` call, in the order the
  example makes them, of the block ids its controller drew (the uniform
  failure, each RANDOM-strategy save), consumed in order
  (``core.blocks.ReplayDraws``).

Without ``draws`` the model draws its own inputs from CPU generators and
the controller its own failures.
"""
from __future__ import annotations

import argparse
import itertools
from typing import Iterator, Optional

from repro_torch.device import DeviceLike
from repro_torch.models.classic import IterativeModel, make_model, with_draws

# examples/quickstart.py's model: the paper's MLR at a size that runs in
# seconds
MLR = dict(n=600, dim=64, n_classes=5, batch=200)


def mlr_model(device: DeviceLike, draws: Optional[dict] = None
              ) -> IterativeModel:
    """``make_model("mlr", **MLR)`` on ``device``, fed ``draws`` where
    given."""
    model = make_model("mlr", device=device, **MLR)
    if draws is None:
        return model
    return with_draws(model, draws["batches"], eps=draws.get("eps"),
                      x_star=draws.get("x_star"))


def run_draws(draws: Optional[dict]) -> Iterator[Optional[list]]:
    """The recorded block draws of each ``run_with_failure`` call in turn
    (None for each where there are none: the controller draws)."""
    if draws is None or "blocks" not in draws:
        return itertools.repeat(None)
    return iter(draws["blocks"])


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' ``--device`` flag."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def printer(verbose: bool):
    return print if verbose else (lambda *a, **k: None)
