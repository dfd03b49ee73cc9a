"""Memoization support, mirroring ``pymc3/memoize.py:23-93``. The port
keeps only the base class ``Model`` derives from: identity hashing, and
pickling that drops a cache."""

__all__ = ["WithMemoization"]


class WithMemoization:
    def __hash__(self):
        return hash(id(self))

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_cache", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
