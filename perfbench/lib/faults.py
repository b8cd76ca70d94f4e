"""Faults planted in the program under the timed path, to show that the
check catches them: each patches one of the program's functions for the
duration of a ``with planted(name):`` block.

- ``answer_altered``: the scoring forward's logits of one position of
  every row come out rolled by one over the vocabulary;
- ``state_unchanged``: the train step's optimizer update does nothing;
- ``half_batch``: the train step's loss leaves out the second half of the
  labels and takes the mean over the rest;
- ``input_altered``: the train step sees one input token changed.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, Iterator, Tuple


def _answer_altered() -> Tuple[object, str, Callable]:
    import repro_torch.models as mod
    real = mod.forward

    def forward(*a, **kw):
        logits, cache = real(*a, **kw)
        pos = logits.shape[1] // 2
        logits[:, pos] = logits[:, pos].roll(1, -1)
        return logits, cache
    return mod, "forward", forward


def _state_unchanged() -> Tuple[object, str, Callable]:
    import repro_torch.train.step as mod

    def adamw_update(c, params, grads, state, gnorm=None):
        return params, state
    return mod, "adamw_update", adamw_update


def _labels(edit: Callable) -> Tuple[object, str, Callable]:
    import repro_torch.train.step as mod
    real = mod.nll_terms

    def nll_terms(params, batch, **kw):
        return real(params, edit(dict(batch)), **kw)
    return mod, "nll_terms", nll_terms


def _half(b: Dict) -> Dict:
    lab = b["labels"].clone()
    lab[..., lab.shape[-1] // 2:] = -1
    b["labels"] = lab
    return b


def _one_token(b: Dict) -> Dict:
    tok = b["tokens"].clone()
    tok[..., tok.shape[-1] // 2] += 1
    b["tokens"] = tok
    return b


FAULTS = {"answer_altered": _answer_altered,
          "state_unchanged": _state_unchanged,
          "half_batch": lambda: _labels(_half),
          "input_altered": lambda: _labels(_one_token)}


@contextmanager
def planted(name: str) -> Iterator[None]:
    mod, attr, fn = FAULTS[name]()
    real = getattr(mod, attr)
    setattr(mod, attr, fn)
    try:
        yield
    finally:
        setattr(mod, attr, real)
