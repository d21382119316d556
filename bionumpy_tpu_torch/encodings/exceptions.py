class EncodingError(Exception):
    """Raised when bytes cannot be encoded; carries the flat offset of the
    first offending byte (reference: bionumpy/encodings/exceptions.py:1-4)."""

    def __init__(self, message, offset=0):
        super().__init__(message)
        self.message = message
        self.offset = offset
