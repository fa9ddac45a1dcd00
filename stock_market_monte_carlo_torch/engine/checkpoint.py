"""Checkpoint and resume of long ``simulate_stats`` runs.

Counterpart of ``stock_market_monte_carlo_tpu/engine/checkpoint.py``.
The engine merges each chunk's stats row and histogram on the host in
float64, in chunk order, so after every chunk it can persist

    {next_offset, paths_done, packed_stats, histogram, config_fingerprint}

and a restarted run continues from the next chunk with bit-identical
totals: the counter stream makes chunk k's draws independent of who drew
chunks 0..k-1.

Format: one ``.npz``, written to a temporary file and renamed over the
target, so a crash never leaves a torn file. The fingerprint covers every
input that changes the sampled stream or the merged totals (model and
strategy fields, seed, n_paths, n_periods, capital, target, histogram
spec, and the engine's stream tag); a mismatch refuses to resume. It does
not cover the chunk size or the device, which leave the stream as it is.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Optional

import numpy as np


def _leaf_repr(x):
    """(dtype, shape, sha256 prefix of the bytes) of an array field, as the
    JAX package hashes a pytree leaf."""
    arr = np.asarray(x)
    return [str(arr.dtype), arr.shape,
            hashlib.sha256(arr.tobytes()).hexdigest()[:16]]


def _fields_repr(obj):
    """Every dataclass field of a model or strategy, by name: strings and
    integers (``HistoricalBootstrap.rng``, the Sobol ``index_offset``) by
    value, the rest (floats, tables, direction numbers) as ``_leaf_repr``.
    The static fields change the sampled stream as much as the arrays."""
    out = [type(obj).__name__]
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        static = isinstance(v, (str, int)) and not isinstance(v, bool)
        out.append([f.name, repr(v) if static else _leaf_repr(v)])
    return out


def config_fingerprint(model, strategy, n_paths, n_periods,
                       initial_capital, seed, target_amount, spec,
                       stream) -> str:
    """sha256 of the run's identity; ``stream`` is the engine's stream tag
    (the port, the effective sampler, histogram and segment tags)."""
    payload = {
        "model_kind": model.kind,
        "model_fields": _fields_repr(model),
        "strategy_kind": strategy.kind,
        "strategy_fields": _fields_repr(strategy),
        "n_paths": int(n_paths),
        "n_periods": int(n_periods),
        "initial_capital": float(initial_capital),
        "seed": int(seed),
        "target_amount": (None if target_amount is None
                          else float(target_amount)),
        "spec": [spec.lo, spec.hi, spec.n_bins],
        "stream": stream,
    }
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


@dataclasses.dataclass
class CheckpointState:
    fingerprint: str
    next_offset: int
    paths_done: int
    stats: np.ndarray      # packed stats vector (float64)
    hist: np.ndarray       # histogram counts (float64)


def save(path: str, state: CheckpointState) -> None:
    """Atomic write: a temporary file in the target's directory, then
    ``os.replace``, so a crash never corrupts the checkpoint."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                fingerprint=np.frombuffer(
                    state.fingerprint.encode(), dtype=np.uint8
                ),
                next_offset=np.int64(state.next_offset),
                paths_done=np.int64(state.paths_done),
                stats=state.stats.astype(np.float64),
                hist=state.hist.astype(np.float64),
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str, expected_fingerprint: str) -> Optional[CheckpointState]:
    """The checkpoint at ``path``, or None if there is none. Raises
    ValueError on a fingerprint mismatch: resuming another run would
    silently corrupt the statistics."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        fp = bytes(z["fingerprint"]).decode()
        if fp != expected_fingerprint:
            raise ValueError(
                f"checkpoint {path!r} belongs to a different run "
                f"(fingerprint {fp[:12]}... != expected "
                f"{expected_fingerprint[:12]}...); delete it or point "
                "checkpoint_path elsewhere"
            )
        return CheckpointState(
            fingerprint=fp,
            next_offset=int(z["next_offset"]),
            paths_done=int(z["paths_done"]),
            stats=np.asarray(z["stats"], np.float64),
            hist=np.asarray(z["hist"], np.float64),
        )
