"""A dict with attribute access, used for YAML-derived settings and batches."""

from collections import OrderedDict


class AttrDict(OrderedDict):
    """Ordered dict whose items are also attributes."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_OrderedDict"):
            super().__setattr__(name, value)
        else:
            self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    def copy(self):
        return attrdictify(dict(self))


def attrdictify(obj):
    """Recursively convert dicts (and dicts inside lists/tuples) to AttrDict."""
    if isinstance(obj, dict):
        return AttrDict((k, attrdictify(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(attrdictify(v) for v in obj)
    return obj
