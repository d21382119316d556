"""IO exceptions carrying file line numbers (reference:
bionumpy/io/exceptions.py)."""


class ParsingException(Exception):
    pass


class FormatException(ParsingException):
    def __init__(self, message, line_number=0):
        super().__init__(message)
        self.message = message
        self.line_number = line_number

    def __str__(self):
        return f"{self.message} (line {self.line_number})"
