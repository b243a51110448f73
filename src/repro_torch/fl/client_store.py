"""Sharded, out-of-core client-state store for the hierarchical fleet
(DESIGN.md §12).

The port's copy of ``repro/fl/client_store.py``, equal to it but for its
imports (the port imports nothing of the JAX package);
``tests/test_torch_core.py`` holds the two copies equal.

The flat async server keeps every per-client DASHA-PP tracker
(``g_i``, ``h_i``, and for finite-MVR the component table ``h_ij``) as
dense ``(n, d)`` jax arrays — fine for tens of clients, hopeless for
the ROADMAP's million-client fleet, where ``(n, d)`` float32 at
n = 1e6, d = 256 is already a GiB per field.  The fleet runtime only
ever touches the *cohort* rows of those tables each round, so the store
holds them out of core: one numpy array (``ram`` backend) or one
``.npy`` memmap (``memmap`` backend) **per edge chunk**, with clients
assigned to contiguous index ranges per edge aggregator.  Gathers and
scatters address global client ids and are routed to the owning chunk,
so a round with a 64-client cohort reads/writes 64 rows regardless of
``n``.

The chunking deliberately mirrors the aggregation tree's leaf tier:
an edge aggregator's clients live in one chunk, so per-edge batch
updates (the h-row writes at edge flush) touch exactly one file.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np

BACKENDS = ("ram", "memmap")


def edge_partition(n: int, num_edges: int) -> np.ndarray:
    """Contiguous near-equal split of ``range(n)`` into ``num_edges``
    chunks: ascending bounds array of shape ``(num_edges + 1,)`` with
    ``bounds[0] == 0`` and ``bounds[-1] == n``.  Chunk sizes differ by
    at most one (the first ``n % num_edges`` edges get the extra
    client), matching :func:`numpy.array_split` order."""
    if num_edges < 1:
        raise ValueError(f"num_edges must be >= 1, got {num_edges}")
    if n < num_edges:
        raise ValueError(f"need n >= num_edges, got n={n} < {num_edges}")
    base, extra = divmod(n, num_edges)
    sizes = np.full(num_edges, base, dtype=np.int64)
    sizes[:extra] += 1
    bounds = np.zeros(num_edges + 1, dtype=np.int64)
    np.cumsum(sizes, out=bounds[1:])
    return bounds


class ClientStore:
    """Per-field, edge-chunked row store addressed by global client id.

    ``fields`` maps a field name to its trailing (per-client) shape,
    e.g. ``{"g_i": (d,), "h_i": (d,), "h_ij": (m, d)}``.  All fields
    share the client axis defined by ``bounds`` (see
    :func:`edge_partition`).  ``backend="ram"`` keeps plain numpy
    arrays; ``backend="memmap"`` keeps one ``.npy`` memmap per
    (field, edge) under ``directory`` (a private temporary directory by
    default, removed when the store is closed/garbage-collected).
    """

    def __init__(self, bounds: Sequence[int],
                 fields: Mapping[str, Tuple[int, ...]],
                 *, backend: str = "ram",
                 directory: Optional[str] = None,
                 dtype=np.float32):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"choose from {list(BACKENDS)}")
        self.bounds = np.asarray(bounds, dtype=np.int64)
        if self.bounds.ndim != 1 or len(self.bounds) < 2 \
                or self.bounds[0] != 0 \
                or np.any(np.diff(self.bounds) <= 0):
            raise ValueError(f"bounds must be ascending with bounds[0]=0 "
                             f"and non-empty chunks, got {bounds}")
        self.n = int(self.bounds[-1])
        self.num_edges = len(self.bounds) - 1
        self.backend = backend
        self.dtype = np.dtype(dtype)
        self._shapes: Dict[str, Tuple[int, ...]] = {
            name: tuple(int(s) for s in shape)
            for name, shape in fields.items()}
        self._tmpdir = None
        if backend == "memmap":
            if directory is None:
                self._tmpdir = tempfile.TemporaryDirectory(
                    prefix="fleet_store_")
                directory = self._tmpdir.name
            os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self._chunks: Dict[str, list] = {}
        for name, shape in self._shapes.items():
            chunks = []
            for e in range(self.num_edges):
                rows = int(self.bounds[e + 1] - self.bounds[e])
                full = (rows,) + shape
                if backend == "ram":
                    chunks.append(np.zeros(full, dtype=self.dtype))
                else:
                    path = os.path.join(directory, f"{name}_edge{e}.npy")
                    chunks.append(np.lib.format.open_memmap(
                        path, mode="w+", dtype=self.dtype, shape=full))
            self._chunks[name] = chunks

    # ------------------------------------------------------------------
    @property
    def fields(self) -> Tuple[str, ...]:
        return tuple(self._shapes)

    def field_shape(self, field: str) -> Tuple[int, ...]:
        return self._shapes[field]

    @property
    def nbytes(self) -> int:
        """Total stored bytes across all fields (on disk for the memmap
        backend — NOT resident memory)."""
        per_row = sum(int(np.prod((1,) + s)) for s in self._shapes.values())
        return self.n * per_row * self.dtype.itemsize

    def edge_of(self, idx) -> np.ndarray:
        """Owning edge index for each global client id."""
        idx = np.asarray(idx, dtype=np.int64)
        return np.searchsorted(self.bounds, idx, side="right") - 1

    def edge_slice(self, edge: int) -> slice:
        return slice(int(self.bounds[edge]), int(self.bounds[edge + 1]))

    # ------------------------------------------------------------------
    def _route(self, idx: np.ndarray) -> Iterable[Tuple[int, np.ndarray,
                                                        np.ndarray]]:
        """Yield ``(edge, positions_into_idx, local_rows)`` groups."""
        if len(idx) and (idx.min() < 0 or idx.max() >= self.n):
            raise IndexError(f"client ids out of range [0, {self.n})")
        edges = self.edge_of(idx)
        for e in np.unique(edges):
            pos = np.nonzero(edges == e)[0]
            yield int(e), pos, idx[pos] - int(self.bounds[e])

    def gather(self, field: str, idx) -> np.ndarray:
        """Rows ``field[idx]`` as a fresh ``(len(idx), *shape)`` array."""
        idx = np.asarray(idx, dtype=np.int64)
        out = np.empty((len(idx),) + self._shapes[field], dtype=self.dtype)
        chunks = self._chunks[field]
        for e, pos, local in self._route(idx):
            out[pos] = chunks[e][local]
        return out

    def scatter_set(self, field: str, idx, values) -> None:
        """``field[idx] = values`` (rows must be unique per call)."""
        idx = np.asarray(idx, dtype=np.int64)
        values = np.asarray(values, dtype=self.dtype)
        chunks = self._chunks[field]
        for e, pos, local in self._route(idx):
            chunks[e][local] = values[pos]

    def scatter_add(self, field: str, idx, values) -> None:
        """``field[idx] += values`` (rows must be unique per call)."""
        idx = np.asarray(idx, dtype=np.int64)
        values = np.asarray(values, dtype=self.dtype)
        chunks = self._chunks[field]
        for e, pos, local in self._route(idx):
            chunks[e][local] += values[pos]

    def edge_block(self, field: str, edge: int) -> np.ndarray:
        """The raw per-edge chunk (a view — mutating it mutates the
        store).  Handy for chunked initialization at scale."""
        return self._chunks[field][edge]

    def dense(self, field: str) -> np.ndarray:
        """Materialize the full ``(n, *shape)`` field.  Reference-scale
        parity checks only — defeats the point at fleet scale."""
        return np.concatenate([np.asarray(c)
                               for c in self._chunks[field]], axis=0)

    def flush(self) -> None:
        """Flush memmap chunks to disk (no-op for the ram backend)."""
        if self.backend == "memmap":
            for chunks in self._chunks.values():
                for c in chunks:
                    c.flush()

    def close(self) -> None:
        """Drop chunk references and delete the private temp directory
        (if the store created one)."""
        self._chunks = {}
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None
