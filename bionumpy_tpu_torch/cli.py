"""CLI generation from BNPDataClass-annotated functions (the port's copy
of bionumpy_tpu/cli.py; reference: bionumpy/cli.py:20-53)."""
from __future__ import annotations

import functools
import inspect

from .bnpdataclass.bnpdataclass import BNPDataClass
from .io import bnp_open


class CliWrapper:
    """Convert BNPDataClass-typed arguments into filename options."""

    def __init__(self, *args, **kwargs):
        self._args = args
        self._kwargs = kwargs

    def __call__(self, function):
        argspec = inspect.getfullargspec(function)
        do_write = "return" in argspec.annotations and \
            inspect.isclass(argspec.annotations["return"]) and \
            issubclass(argspec.annotations["return"], BNPDataClass)

        def is_bnpdataclass(name: str) -> bool:
            annotation = argspec.annotations.get(name)
            return inspect.isclass(annotation) and \
                issubclass(annotation, BNPDataClass)

        @functools.wraps(function)
        def new_func(*args, **kwargs):
            new_args = [bnp_open(arg).read()
                        if is_bnpdataclass(argspec.args[i]) else arg
                        for i, arg in enumerate(args)]
            new_kwargs = {k: bnp_open(v).read() if is_bnpdataclass(k)
                          else v for k, v in kwargs.items()
                          if k != "output"}
            return_val = function(*new_args, **new_kwargs)
            if do_write and kwargs.get("output"):
                bnp_open(kwargs["output"], "w").write(return_val)
            return return_val

        sig = inspect.signature(function)
        new_parameters = [
            val.replace(annotation=str)
            if inspect.isclass(val.annotation) and
            issubclass(val.annotation, BNPDataClass) else val
            for val in sig.parameters.values()]
        if do_write:
            new_parameters.append(
                inspect.Parameter("output", inspect.Parameter.KEYWORD_ONLY,
                                  annotation=str, default=None))
        new_func.__signature__ = sig.replace(
            parameters=new_parameters, return_annotation=sig.empty)
        annotations = {name: str if is_bnpdataclass(name) else t
                       for name, t in argspec.annotations.items()
                       if name != "return"}
        if do_write:
            annotations["output"] = str
        new_func.__annotations__ = annotations
        return new_func


def run_as_commandline(function):
    import sys
    args = sys.argv[1:]
    args = (_type(arg) for _type, arg in
            zip(function.__annotations__.values(), args))
    function(*args)
