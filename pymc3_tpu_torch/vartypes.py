"""Variable dtype classification, mirroring ``pymc3/vartypes.py:25-44``."""

__all__ = [
    "bool_types",
    "int_types",
    "float_types",
    "complex_types",
    "continuous_types",
    "discrete_types",
    "typefilter",
    "isgenerator",
]

bool_types = {"int8", "bool"}
int_types = {"int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64"}
float_types = {"float16", "float32", "float64", "bfloat16"}
complex_types = {"complex64", "complex128"}
continuous_types = float_types | complex_types
discrete_types = bool_types | int_types

string_types = {"str"}


def typefilter(vars, types):
    return [v for v in vars if str(v.dtype) in types]


def isgenerator(obj):
    import types
    return isinstance(obj, types.GeneratorType)
