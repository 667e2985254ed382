"""An architecture module that is the mu-law WaveNet and records each hook
the harness calls (``CALLS``).  ``test_bench_arch.py`` copies it, as
``arch/recorder.py``, into a copy of ``port_bench/`` beside a new
configuration that names it, as a later PR would add an architecture."""

from port_bench import spec

_BASE = spec.architecture({"architecture": "wavenet-mulaw"})
CALLS: set = set()
MODEL_KEYS = _BASE.MODEL_KEYS
STEP_FACTORY = _BASE.STEP_FACTORY


def _recorded(name: str):
    hook = getattr(_BASE, name)

    def call(*args, **kwargs):
        CALLS.add(name)
        return hook(*args, **kwargs)
    return call


for _name in spec.ARCH_HOOKS:
    globals()[_name] = _recorded(_name)
