from .core import (RaggedArray, RaggedShape, RaggedView, ragged_slice,
                   unsafe_extend_left, unsafe_extend_right)
from . import functions as _functions  # registers __array_function__ handlers

__all__ = ["RaggedArray", "RaggedShape", "RaggedView", "ragged_slice",
           "unsafe_extend_left", "unsafe_extend_right"]
