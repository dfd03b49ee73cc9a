"""Framework exceptions, mirroring ``pymc3/exceptions.py:24-57``."""

__all__ = [
    "SamplingError",
    "IncorrectArgumentsError",
    "TraceDirectoryError",
    "ImputationWarning",
    "ShapeError",
    "DtypeError",
]


class SamplingError(RuntimeError):
    pass


class IncorrectArgumentsError(ValueError):
    pass


class TraceDirectoryError(ValueError):
    """Trace directory on disk does not have the expected layout."""
    pass


class ImputationWarning(UserWarning):
    """Raised when automatic imputation of missing data is performed."""
    pass


class ShapeError(ValueError):
    def __init__(self, message, actual=None, expected=None):
        if actual is not None and expected is not None:
            super().__init__(f"{message} (actual {actual} != expected {expected})")
        elif actual is not None:
            super().__init__(f"{message} (actual {actual})")
        else:
            super().__init__(message)


class DtypeError(TypeError):
    def __init__(self, message, actual=None, expected=None):
        if actual is not None and expected is not None:
            super().__init__(f"{message} (actual {actual} != expected {expected})")
        else:
            super().__init__(message)
