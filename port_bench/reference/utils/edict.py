"""A minimal attribute-access dict (counterpart of pcseqlearning_tpu.utils.edict).

Configs arrive as nested dicts; ``EDict`` turns them into dotted-attribute
namespaces, converting nested dicts and lists recursively.
"""

from __future__ import annotations


class EDict(dict):
    """dict with attribute access; nested dicts/lists are converted recursively."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        if d is None:
            d = {}
        d = dict(d)
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _convert(v):
        if isinstance(v, dict) and not isinstance(v, EDict):
            return EDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(EDict._convert(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, EDict._convert(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __delattr__(self, k):
        try:
            del self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def copy(self):
        return EDict(self)

    def __deepcopy__(self, memo):
        import copy

        out = EDict()
        memo[id(self)] = out
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out
