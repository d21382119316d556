import typing

SequenceID = typing.NewType("SequenceID", str)
