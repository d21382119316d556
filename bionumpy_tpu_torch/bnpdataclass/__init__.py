from .bnpdataclass import (BNPDataClass, bnpdataclass, dynamic_concatenate,
                           make_dataclass, narrow_type)
from .bnpdataclassfunction import apply_to_npdataclass, replace
from .lazybnpdataclass import LazyBNPDataClass, create_lazy_class, ItemGetter

__all__ = ["bnpdataclass", "BNPDataClass", "make_dataclass", "narrow_type",
           "dynamic_concatenate", "replace", "apply_to_npdataclass",
           "LazyBNPDataClass", "create_lazy_class", "ItemGetter"]
