"""The JAX package's integer engine core, jitted, for the port's tests
that run its serving engine and memory stores eagerly (each eager JAX
primitive compiles on first use, and these functions were most of those
tests' time).

``record_accesses``, ``tiering.tick``, ``telemetry.end_window`` and
``init_state`` are integer and bit arithmetic (counts, histograms, block
swaps and copies of bit patterns), so jitting them changes no result; the
tests that use this still hold every state, stat and token of the port to
the reference's exactly. :func:`jitted_core` swaps them in (``init_state``
where the serving engine and the stores bound it) for the duration of a
``with`` block and puts the originals back after it.
"""
import contextlib

import jax
from repro.core import address_space, telemetry, tiering
from repro.memory import embedding, kvcache, moe_store
from repro.serve import engine

_JITTED = {
    (address_space, "record_accesses"): dict(static_argnames=("cfg", "kernel_backend")),
    (tiering, "tick"): dict(static_argnames=("cfg", "policy", "budget")),
    (telemetry, "end_window"): dict(static_argnames=("cfg",)),
    **{(mod, "init_state"): dict(static_argnames=("cfg",))
       for mod in (embedding, kvcache, moe_store, engine)},
}


@contextlib.contextmanager
def jitted_core():
    originals = {key: getattr(*key) for key in _JITTED}
    try:
        for (mod, name), kw in _JITTED.items():
            setattr(mod, name, jax.jit(originals[(mod, name)], **kw))
        yield
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
