"""A reference class that departs from the plain one, for the tests of
``reference_class``: its head's bias leans by ``LEAN`` towards the even
token ids. (A shift of every id alike would move no softmax and no argmax.)
Named under ``reference_class``, it has to turn a sound run's ``correct``
false."""

import torch

from benchmark.reference.model import Reference

LEAN = 0.5


class _LeaningBias(dict):
    """The weights, with the head's bias read leaning (the leaf itself is
    untouched, so its gradient still flows)."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        if key != "classifier.bias":
            return value
        lean = torch.zeros_like(value)
        lean[::2] = LEAN
        return value + lean


class LeaningHead(Reference):
    def __init__(self, cfg, weights, *args, **kw):
        super().__init__(cfg, _LeaningBias(weights), *args, **kw)
