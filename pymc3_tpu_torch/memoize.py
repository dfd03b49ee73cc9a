"""Memoization, mirroring ``pymc3/memoize.py:23-93``
(cf. ``pymc3_tpu/memoize.py``): ``memoize`` caches a function's results by
its arguments made hashable, ``clear_cache`` empties every such cache, and
``WithMemoization`` (which ``Model`` derives from) hashes by identity and
drops a cache when pickled."""
import functools
import pickle

__all__ = ["memoize", "WithMemoization", "hashable", "clear_cache"]

CACHE_REGISTRY = []


def memoize(obj):
    """Decorator caching a function's return values keyed by its
    arguments."""
    cache = obj._cache = {}
    CACHE_REGISTRY.append(cache)

    @functools.wraps(obj)
    def memoizer(*args, **kwargs):
        key = (hashable(args), hashable(kwargs))
        if key not in cache:
            cache[key] = obj(*args, **kwargs)
        return cache[key]

    memoizer._cache = cache
    return memoizer


def clear_cache():
    """Empty the cache of every function decorated with ``memoize``."""
    for c in CACHE_REGISTRY:
        c.clear()


class WithMemoization:
    def __hash__(self):
        return hash(id(self))

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_cache", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)


def hashable(a):
    """A hashable key for anything: dicts and sequences element by element,
    else the object itself, its pickle's hash, or its identity."""
    if isinstance(a, dict):
        return hashable(tuple((hashable(k), hashable(v))
                              for k, v in a.items()))
    if isinstance(a, (tuple, list)):
        return tuple(hashable(x) for x in a)
    try:
        hash(a)
        return a
    except TypeError:
        pass
    try:
        return hash(pickle.dumps(a))
    except (pickle.PicklingError, TypeError, AttributeError):
        return id(a)
