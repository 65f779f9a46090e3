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

:func:`jitted_service` does the same for what the reference's churn engine
and ``TieringService`` run eagerly outside their jitted windows: a
window's synthesized accesses (``traces.synth_accesses``, which the engine
otherwise runs inside its jitted scan, where the port matches it bit for
bit), the boot-time fault application (``faults.apply_guest_faults``) and
the initial engine state (``engine.init_engine_state``).
"""
import contextlib

import jax
from repro.core import address_space, faults, telemetry, tiering
from repro.core import engine as core_engine
from repro.data import traces
from repro.memory import embedding, kvcache, moe_store
from repro.serve import engine

_JITTED = {
    (address_space, "record_accesses"): dict(static_argnames=("cfg", "kernel_backend")),
    (tiering, "tick"): dict(static_argnames=("cfg", "policy", "budget")),
    (telemetry, "end_window"): dict(static_argnames=("cfg",)),
    **{(mod, "init_state"): dict(static_argnames=("cfg",))
       for mod in (embedding, kvcache, moe_store, engine)},
}
_SERVICE = {
    (traces, "synth_accesses"): dict(static_argnums=(0,)),
    (faults, "apply_guest_faults"): dict(static_argnums=(0,)),
    (core_engine, "init_engine_state"): dict(static_argnums=(0,)),
}


@contextlib.contextmanager
def _swapped(table: dict):
    originals = {key: getattr(*key) for key in table}
    try:
        for (mod, name), kw in table.items():
            setattr(mod, name, jax.jit(originals[(mod, name)], **kw))
        yield
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)


def jitted_core():
    return _swapped(_JITTED)


def jitted_service():
    return _swapped(_SERVICE)
