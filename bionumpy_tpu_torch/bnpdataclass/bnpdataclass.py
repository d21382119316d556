"""Typed record model: dataclasses whose fields are column arrays.

The port's copy of bionumpy_tpu/bnpdataclass/bnpdataclass.py, a
re-design of bionumpy's @bnpdataclass/npdataclass stack
(bionumpy/bnpdataclass/bnpdataclass.py:274-494 and the external
npstructures.npdataclass).  A record batch is a tree of column arrays:
numeric and encoded columns are flat buffers + offsets.
"""
from __future__ import annotations

import dataclasses
import inspect
from numbers import Number
from typing import Any, Dict, Iterable, List, Optional, Tuple, Type, Union

import numpy as np

from ..encoded_array import (EncodedArray, EncodedRaggedArray,
                             as_encoded_array)
from ..encodings import Encoding, NumericEncoding
from ..encodings.alphabet_encoding import FlatAlphabetEncoding
from ..ragged import RaggedArray
from ..string_array import StringArray, as_string_array
from ..typing import SequenceID
from ..util import is_subclass_or_instance

_NUMERIC_TYPES = (int, float, bool)
_OPTIONAL_NUMERIC = tuple(Optional[t] for t in _NUMERIC_TYPES)


def _field_len(value) -> int:
    if isinstance(value, (EncodedRaggedArray, RaggedArray, StringArray)):
        return len(value)
    if isinstance(value, EncodedArray):
        return len(value) if value.ndim >= 1 else 1
    if isinstance(value, np.ndarray):
        return len(value) if value.ndim >= 1 else 1
    if isinstance(value, BNPDataClass):
        return len(value)
    return len(value)


def _index_field(value, idx):
    if isinstance(value, (EncodedRaggedArray, RaggedArray, StringArray,
                          EncodedArray, BNPDataClass)):
        return value[idx]
    return np.asarray(value)[idx]


def _concat_fields(values):
    first = values[0]
    if isinstance(first, (EncodedRaggedArray, RaggedArray, EncodedArray,
                          StringArray)):
        return np.concatenate(list(values))
    if isinstance(first, BNPDataClass):
        return np.concatenate(list(values))
    return np.concatenate([np.asarray(v) for v in values])


def _vanilla_iter(value):
    if isinstance(value, StringArray):
        return iter(value.tolist())
    if isinstance(value, np.ndarray):
        conv = (lambda x: x.item()) if value.ndim == 1 else (lambda x: x.tolist())
        return (conv(v) for v in value)
    if isinstance(value, (EncodedArray, EncodedRaggedArray)):
        return (row.to_string() for row in value)
    if isinstance(value, RaggedArray):
        return (row.tolist() for row in value)
    if isinstance(value, BNPDataClass):
        return value.toiter()
    return iter(value)


class BNPDataClass:
    """Base providing numpy-like indexing over all fields
    (reference: bionumpy/bnpdataclass/bnpdataclass.py:37-271)."""

    # -- construction ---------------------------------------------------------
    @classmethod
    def _fields(cls):
        return dataclasses.fields(cls)

    @classmethod
    def _from_raw(cls, **field_values) -> "BNPDataClass":
        obj = object.__new__(cls)
        for name, val in field_values.items():
            object.__setattr__(obj, name, val)
        return obj

    @classmethod
    def empty(cls) -> "BNPDataClass":
        kwargs = {}
        for field in dataclasses.fields(cls):
            if field.type in _NUMERIC_TYPES + _OPTIONAL_NUMERIC:
                kwargs[field.name] = np.empty(0, dtype=field.type
                                              if field.type in _NUMERIC_TYPES
                                              else float)
            elif inspect.isclass(field.type) and issubclass(field.type,
                                                            BNPDataClass):
                kwargs[field.name] = field.type.empty()
            else:
                kwargs[field.name] = []
        return cls(**kwargs)

    @classmethod
    def from_entry_tuples(cls, tuples: Iterable[tuple]) -> "BNPDataClass":
        return cls(*(list(col) for col in zip(*tuples)))

    # -- numpy-like behaviour -------------------------------------------------
    def shallow_tuple(self) -> tuple:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def __len__(self) -> int:
        fields = dataclasses.fields(self)
        if not fields:
            return 0
        return _field_len(getattr(self, fields[0].name))

    def __getitem__(self, idx):
        single = isinstance(idx, (int, np.integer))
        values = {f.name: _index_field(getattr(self, f.name), idx)
                  for f in dataclasses.fields(self)}
        out = self.__class__._from_raw(**values)
        if single:
            object.__setattr__(out, "_is_single_entry", True)
        if hasattr(self, "_context"):
            object.__setattr__(out, "_context", dict(self._context))
        return out

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __eq__(self, other):
        if other.__class__ is not self.__class__:
            return NotImplemented
        return all(self._field_equal(getattr(self, f.name),
                                     getattr(other, f.name))
                   for f in dataclasses.fields(self))

    @staticmethod
    def _field_equal(a, b) -> bool:
        if isinstance(a, (EncodedRaggedArray, RaggedArray)):
            if len(a) != len(b) or not np.array_equal(a.lengths, b.lengths):
                return False
            ar = a.ravel()
            br = b.ravel()
            ar = ar.raw() if hasattr(ar, "raw") else ar
            br = br.raw() if hasattr(br, "raw") else br
            return np.array_equal(ar, br)
        if isinstance(a, EncodedArray):
            return np.array_equal(a.raw(), b.raw() if hasattr(b, "raw") else b)
        if isinstance(a, StringArray):
            return np.array_equal(a.raw(), b.raw() if hasattr(b, "raw") else b)
        if isinstance(a, BNPDataClass):
            return a == b
        return np.array_equal(np.asarray(a), np.asarray(b))

    def __array_function__(self, func, types, args, kwargs):
        if func is np.concatenate:
            objs = list(args[0])
            assert all(o.__class__ is self.__class__ for o in objs)
            values = {f.name: _concat_fields([getattr(o, f.name) for o in objs])
                      for f in dataclasses.fields(self)}
            return self.__class__._from_raw(**values)
        return NotImplemented

    # -- conversion -----------------------------------------------------------
    def todict(self) -> Dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if isinstance(val, BNPDataClass):
                out.update({f"{f.name}.{k}": v for k, v in val.todict().items()})
            elif isinstance(val, (EncodedArray, EncodedRaggedArray, StringArray)):
                out[f.name] = val.tolist()
            elif isinstance(val, RaggedArray):
                out[f.name] = val.tolist()
            else:
                out[f.name] = np.asarray(val)
        return out

    def topandas(self):
        import pandas as pd
        return pd.DataFrame(self.todict())

    @classmethod
    def from_dict(cls, dict_object: Dict[str, Any]) -> "BNPDataClass":
        from collections import defaultdict
        new_dict = defaultdict(dict)
        field_names = {f.name for f in dataclasses.fields(cls)}
        for name, value in dict_object.items():
            if "." in name:
                name, subname = name.split(".", maxsplit=1)
                new_dict[name][subname] = value
            elif name in field_names:
                new_dict[name] = value
        for field in dataclasses.fields(cls):
            if isinstance(new_dict[field.name], dict) and \
                    is_subclass_or_instance(field.type, BNPDataClass):
                new_dict[field.name] = field.type.from_dict(new_dict[field.name])
        return cls(**new_dict)

    @classmethod
    def from_data_frame(cls, df) -> "BNPDataClass":
        return cls.from_dict(df.to_dict("series"))

    def toiter(self):
        iters = tuple(_vanilla_iter(getattr(self, f.name))
                      for f in dataclasses.fields(self))
        plain = self.plain_dataclass()
        return (plain(*row) for row in zip(*iters))

    to_iter = toiter

    def tolist(self) -> list:
        return list(self.toiter())

    @classmethod
    def plain_dataclass(cls):
        if "_plain_dataclass" not in cls.__dict__:
            fields = [(f.name, Any) for f in dataclasses.fields(cls)]
            cls._plain_dataclass = dataclasses.make_dataclass(cls.__name__,
                                                              fields)
        return cls._plain_dataclass

    @property
    def dataclass(self):
        return self.plain_dataclass()

    # -- modification ---------------------------------------------------------
    @classmethod
    def extend(cls, fields: tuple, name: str = None) -> Type["BNPDataClass"]:
        cls_name = name if name is not None else (
            f"Dynamic{cls.__name__}" if not cls.__name__.startswith("Dynamic")
            else cls.__name__)
        return bnpdataclass(
            dataclasses.make_dataclass(cls_name, bases=(cls,), fields=fields))

    def add_fields(self, fields: Dict[str, Any],
                   field_type_map: dict = None) -> "BNPDataClass":
        for name in fields:
            if not name.isidentifier():
                raise TypeError(f"invalid field name: {name}")
        fields_with_types = _extract_field_types(fields, field_type_map)
        new_class = self.__class__.extend(tuple(fields_with_types.items()))
        current = {f.name: getattr(self, f.name)
                   for f in dataclasses.fields(self)}
        return new_class(**{**current, **fields})

    def sort_by(self, field_name: str) -> "BNPDataClass":
        return self[np.argsort(getattr(self, field_name))]

    def astype(self, new_class: Type["BNPDataClass"]) -> "BNPDataClass":
        kwargs = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(new_class)
                  if hasattr(self, f.name)}
        return new_class(**kwargs)

    # -- context --------------------------------------------------------------
    def set_context(self, name: str, value: Any):
        if not hasattr(self, "_context"):
            object.__setattr__(self, "_context", {})
        self._context[name] = value

    def get_context(self, name: str) -> Any:
        if not hasattr(self, "_context"):
            object.__setattr__(self, "_context", {})
        return self._context[name]

    def has_context(self, name: str) -> bool:
        return hasattr(self, "_context") and name in self._context

    # -- repr -----------------------------------------------------------------
    def __repr__(self):
        if getattr(self, "_is_single_entry", False):
            parts = ", ".join(f"{f.name}={getattr(self, f.name)!r}"
                              for f in dataclasses.fields(self))
            return f"{self.__class__.__name__}({parts})"
        n = len(self)
        lines = [f"{self.__class__.__name__} with {n} entries"]
        names = [f.name for f in dataclasses.fields(self)]
        lines.append("".join(f"{name[:20]:>25}" for name in names))
        for entry in list(self[: min(n, 10)].toiter()):
            lines.append("".join(
                f"{str(getattr(entry, name))[:20]:>25}" for name in names))
        return "\n".join(lines)

    __str__ = __repr__


def _convert_single_field(field, pre_val):
    """Field coercion table (reference semantics:
    bionumpy/bnpdataclass/bnpdataclass.py:352-408)."""
    array_like = (str, list, EncodedArray, EncodedRaggedArray, RaggedArray,
                  np.ndarray)
    if field.type == Union[BNPDataClass, str]:
        if isinstance(pre_val, array_like) or hasattr(pre_val, "to_numpy"):
            return as_encoded_array(pre_val)
        return pre_val
    if field.type in _NUMERIC_TYPES + _OPTIONAL_NUMERIC:
        return np.asarray(pre_val)
    if field.type == str:
        return as_encoded_array(pre_val)
    if field.type == SequenceID or field.type == List[str]:
        if isinstance(pre_val, EncodedArray):
            return pre_val
        return as_string_array(pre_val)
    if is_subclass_or_instance(field.type, Encoding):
        if is_subclass_or_instance(field.type, NumericEncoding):
            val = as_encoded_array(pre_val, _as_encoding_instance(field.type))
        elif getattr(field.type, "returns_raw", False) and \
                isinstance(pre_val, (np.ndarray, np.generic)):
            val = pre_val
        else:
            val = as_encoded_array(pre_val, _as_encoding_instance(field.type))
        if isinstance(field.type, FlatAlphabetEncoding) and \
                isinstance(val, (EncodedArray, EncodedRaggedArray)):
            val = val.ravel()
        return val
    if field.type in (List[int], List[bool], List[float]):
        if isinstance(pre_val, RaggedArray):
            return pre_val
        try:
            return RaggedArray(pre_val)
        except TypeError:
            return np.asarray(pre_val)
    if inspect.isclass(field.type) and issubclass(field.type, BNPDataClass):
        return pre_val
    raise AssertionError(f"unsupported field type {field.type}")


def _as_encoding_instance(enc):
    return enc if isinstance(enc, Encoding) else enc()


def _resolve_string_annotations(cls):
    """`from __future__ import annotations` turns field types into strings;
    resolve them against the defining module + typing namespace."""
    import sys
    import typing
    module = sys.modules.get(cls.__module__)
    namespace = dict(vars(typing))
    if module is not None:
        namespace.update(vars(module))
    for field in dataclasses.fields(cls):
        if isinstance(field.type, str):
            try:
                field.type = eval(field.type, namespace)  # noqa: S307
            except Exception:
                pass
    return cls


def bnpdataclass(base_class: type) -> Type[BNPDataClass]:
    """Decorator: dataclass whose fields are coerced column arrays
    (reference: bionumpy/bnpdataclass/bnpdataclass.py:274-413).

    Examples
    --------
    >>> from bionumpy_tpu_torch.bnpdataclass import bnpdataclass
    >>> @bnpdataclass
    ... class Person:
    ...     name: str
    ...     age: int
    >>> people = Person(["alice", "bob"], [30, 40])
    >>> people[people.age > 35]
    Person with 1 entries
                         name                      age
                          bob                       40
    """
    if not issubclass(base_class, BNPDataClass):
        base_class = type(base_class.__name__, (base_class, BNPDataClass),
                          dict(base_class.__dict__))
    cls = dataclasses.dataclass(repr=False, eq=False)(base_class)
    cls = _resolve_string_annotations(cls)

    original_init = cls.__init__

    def __init__(self, *args, **kwargs):
        original_init(self, *args, **kwargs)
        for field in dataclasses.fields(self):
            pre_val = getattr(self, field.name)
            try:
                val = _convert_single_field(field, pre_val)
            except Exception as e:
                raise ValueError(
                    f"Error when converting {field.name} to {field.type} "
                    f"with value {pre_val}") from e
            object.__setattr__(self, field.name, val)

    cls.__init__ = __init__
    return cls


def shallow_tuple(obj: BNPDataClass) -> tuple:
    """Module-level form of BNPDataClass.shallow_tuple (reference:
    npstructures.npdataclasses.shallow_tuple)."""
    return obj.shallow_tuple()


def make_dataclass(fields: List[Tuple], name: str = "DynamicDC",
                   bases=()) -> Type[BNPDataClass]:
    """Dynamic record types (CSV headers, VCF INFO) — reference:
    bionumpy/bnpdataclass/bnpdataclass.py:416-436."""
    if not bases:
        bases = (BNPDataClass,)
    return bnpdataclass(dataclasses.make_dataclass(name, fields=fields,
                                                   bases=bases))


def narrow_type(bnp_dc: Type[BNPDataClass], field_name: str,
                field_type: type) -> Type[BNPDataClass]:
    new_fields = [(f.name, field_type) if f.name == field_name
                  else (f.name, f.type) for f in dataclasses.fields(bnp_dc)]
    return make_dataclass(new_fields, name=bnp_dc.__name__, bases=(bnp_dc,))


def _extract_field_types(fields_with_values: dict,
                         field_type_map: dict = None) -> dict:
    out = {}
    for name, values in fields_with_values.items():
        if field_type_map is not None and name in field_type_map:
            out[name] = field_type_map[name]
        elif isinstance(values[0], EncodedArray):
            out[name] = type(values[0].encoding)
        elif isinstance(values[0], Number):
            out[name] = type(values[0])
        else:
            out[name] = type(values[0])
    return out


def dynamic_concatenate(dataclass_iter: Iterable[BNPDataClass]):
    iterable = iter(dataclass_iter)
    first = next(iterable)
    columns = [[val] for val in first.shallow_tuple()]
    for chunk in iterable:
        for col, val in zip(columns, chunk.shallow_tuple()):
            col.append(val)
    return first.__class__._from_raw(**{
        f.name: _concat_fields(col)
        for f, col in zip(dataclasses.fields(first), columns)})
