"""Import-path parity shim (reference: bionumpy/encodings/base_encoding.py):
the base/ASCII encodings live on encoded_array in this build."""
from ..encoded_array import (ASCIIEncoding, BaseEncoding, Encoding,
                             NumericEncoding, OneToOneEncoding)

__all__ = ["ASCIIEncoding", "BaseEncoding", "Encoding", "NumericEncoding",
           "OneToOneEncoding"]
