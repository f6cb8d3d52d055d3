"""ANIL, Almost No Inner Loop (``howtotrainyourmamlpytorch_tpu/models/anil.py``):
MAML with the inner loop restricted to the classifier head. The conv body
is frozen through adaptation and meta-trained by the outer optimizer.

The learner only narrows ``adapt_mask``, the partition MAML routes every
adapt path (train, eval, serve) and the LSLR table through
(``models/maml.py``), so everything else is MAML's: second order, MSL,
remat, the sentinel, the checkpoint layout with LSLR rows for ``linear/*``
only, and the train step as a CUDA graph (``models/step_graph.py``).
"""

from __future__ import annotations

from typing import Any

from ..utils.trees import tree_map_with_path
from .maml import MAMLFewShotLearner

Tree = Any


class ANILLearner(MAMLFewShotLearner):
    """MAML whose fast weights are the head's alone."""

    def adapt_mask(self, theta: Tree) -> Tree:
        """True on ``linear/*``: the body, norm parameters included, is
        frozen through adaptation."""
        return tree_map_with_path(lambda path, _: path[0] == "linear", theta)
