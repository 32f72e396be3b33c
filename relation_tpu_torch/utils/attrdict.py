"""Attribute-access dict, a stand-in for the ``easydict.EasyDict`` of the
reference config layer (reference: relation_rcnn/config/config.py:16-18).
The port's own copy of relation_tpu/utils/attrdict.py."""

from __future__ import annotations


class AttrDict(dict):
    """dict subclass whose items are also attributes. Nested dicts are converted."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _convert(v):
        if isinstance(v, dict) and not isinstance(v, AttrDict):
            return AttrDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(AttrDict._convert(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, AttrDict._convert(v))

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

    def copy(self) -> "AttrDict":
        out = AttrDict()
        for k, v in self.items():
            out[k] = v.copy() if isinstance(v, AttrDict) else v
        return out
