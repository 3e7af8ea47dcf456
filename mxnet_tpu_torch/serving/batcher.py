"""Deadline-aware dynamic batching over a fixed compiled batch shape.

The AOT executable's signature is frozen at export: ``fwd(params,
inputs)`` with a fixed leading batch dimension B (deploy.py).  Dynamic
batching therefore means *packing*: requests carrying 1..B rows each are
concatenated (zero-padded up to B) into one device dispatch, and the
outputs are sliced back per request.

A batch CLOSES at the first of:

* ``rows == max_rows``                  (full — dispatch now),
* the earliest member's ``deadline - margin``   (wait any longer and
  that member cannot make its deadline; ``margin`` tracks observed
  execution time, see runtime),
* ``first_member_arrival + linger``     (bounded wait so a lone request
  on an idle server is not held hostage by a far-away deadline).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .admission import AdmissionQueue
from .errors import ServingError
from .request import Request

__all__ = ["normalize_inputs", "collect_batch", "pack", "unpack"]


def normalize_inputs(inputs: Dict[str, object], input_names: Sequence[str],
                     input_shapes: Dict[str, Tuple[int, ...]],
                     input_dtypes: Dict[str, np.dtype],
                     max_rows: int) -> Tuple[Dict[str, np.ndarray], int]:
    """Validate + coerce caller inputs to ``(rows, *example_shape)``
    arrays; returns ``(arrays, rows)``.  Accepts a single example
    (example shape), a sub-batch ``(r, *example)``, or the full batch."""
    missing = [n for n in input_names if n not in inputs]
    if missing:
        raise ServingError("missing inputs %s" % missing)
    unknown = [n for n in inputs if n not in input_names]
    if unknown:
        raise ServingError("unknown inputs %s" % unknown)
    rows = None
    arrays = {}
    for n in input_names:
        example = tuple(input_shapes[n][1:])
        arr = np.asarray(inputs[n], input_dtypes[n])
        if arr.shape == example:
            arr, r = arr[None], 1
        elif arr.ndim == len(example) + 1 and tuple(arr.shape[1:]) == example:
            r = arr.shape[0]
        else:
            raise ServingError(
                "input %r has shape %s; want %s (one example) or "
                "(rows<=%d,)+%s" % (n, arr.shape, example, max_rows,
                                    example))
        if r < 1 or r > max_rows:
            raise ServingError(
                "input %r carries %d rows; the compiled batch holds at "
                "most %d" % (n, r, max_rows))
        if rows is None:
            rows = r
        elif rows != r:
            raise ServingError(
                "inconsistent row counts across inputs (%d vs %d for %r)"
                % (rows, r, n))
        arrays[n] = arr
    return arrays, rows


def collect_batch(queue: AdmissionQueue, first: Request, max_rows: int,
                  linger: float,
                  margin_fn: Callable[[], float]) -> List[Request]:
    """Grow a batch from ``first`` until a close condition (see module
    docstring).  A popped request that does not fit goes back to the
    queue head for the next batch."""
    batch = [first]
    rows = first.rows
    started = time.monotonic()

    def close_by():
        t = started + linger
        margin = margin_fn()
        for r in batch:
            if r.deadline is not None:
                t = min(t, r.deadline - margin)
        return t

    while rows < max_rows:
        wait = close_by() - time.monotonic()
        if wait <= 0:
            break
        req = queue.pop_live(timeout=min(wait, 0.05))
        if req is None:
            if time.monotonic() >= close_by():
                break
            continue
        if rows + req.rows > max_rows:
            queue.push_front(req)
            break
        batch.append(req)
        rows += req.rows
    return batch


def pack(batch: Sequence[Request], input_names: Sequence[str],
         input_shapes: Dict[str, Tuple[int, ...]],
         input_dtypes: Dict[str, np.dtype]) -> Dict[str, np.ndarray]:
    """Concatenate the batch's rows into full compiled-shape arrays,
    zero-padding the tail rows the batch did not fill."""
    packed = {}
    for n in input_names:
        full = np.zeros(tuple(input_shapes[n]), input_dtypes[n])
        off = 0
        for req in batch:
            full[off:off + req.rows] = req.inputs[n]
            off += req.rows
        packed[n] = full
    return packed


def unpack(outputs: Sequence[np.ndarray], batch: Sequence[Request],
           batch_rows: int) -> List[List[np.ndarray]]:
    """Slice each output back per request (row-aligned outputs only: an
    output whose leading dim is not the batch dim — e.g. a scalar
    summary — is handed to every request whole)."""
    per_request = []
    off = 0
    for req in batch:
        outs = []
        for o in outputs:
            o = np.asarray(o)
            if o.ndim >= 1 and o.shape[0] == batch_rows:
                outs.append(o[off:off + req.rows])
            else:
                outs.append(o)
        per_request.append(outs)
        off += req.rows
    return per_request
