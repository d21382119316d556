"""Global config flags (reference: bionumpy/config.py:1-16)."""

LAZY = True
STRING_ARRAY = True


class ConfigContext:
    def __init__(self, **kwargs):
        self._overrides = kwargs
        self._saved = {}

    def __enter__(self):
        import sys
        module = sys.modules[__name__]
        for key, value in self._overrides.items():
            self._saved[key] = getattr(module, key)
            setattr(module, key, value)
        return self

    def __exit__(self, *args):
        import sys
        module = sys.modules[__name__]
        for key, value in self._saved.items():
            setattr(module, key, value)
        return False
