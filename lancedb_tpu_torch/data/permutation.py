"""Permutation tables: deterministic splits + shuffles over a base table.

A copy of the JAX package's data/permutation.py (host code), with the
port's imports; a pickled table carries its connection's device, so the
copy reopened in another process runs where the original ran.

Reference: python permutation.py:21-234 `PermutationBuilder` and the
rust dataloader/permutation/{builder,split,shuffle,reader}.rs. A
permutation is itself a table of (row_id, split_id) committed through
the normal storage layer, so it is versioned, shareable between
processes, and readable by row offset — the contract StreamingDataset
builds on.

Split strategies (reference split.rs:31-78):
  * no_split     — everything in split 0
  * random       — seeded shuffle, then fractional/count sizes
  * hash         — hash of key columns → weighted buckets (+ discard)
  * sequential   — contiguous blocks in row order
  * calculated   — SQL expression produces the split id per row
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
import numpy as np
import pyarrow as pa

from ..errors import InvalidInputError
from ..filters.eval import evaluate_expression
from ..storage.dataset import ROW_ID_COL

SPLIT_COL = "split_id"


@dataclass
class _SplitSpec:
    kind: str = "none"
    seed: int = 42
    fractions: list[float] | None = None
    counts: list[int] | None = None
    clump_size: int | None = None
    columns: list[str] | None = None
    split_weights: list[int] | None = None
    discard_weight: int = 0
    sql: str | None = None
    sizes: list[int] | None = None
    split_names: list[str] | None = None


def _check_split_names(names: list[str] | None, n_splits: int) -> None:
    if names is None:
        return
    if len(names) != n_splits:
        raise InvalidInputError(
            f"split_names has {len(names)} entries for {n_splits} splits"
        )
    if len(set(names)) != len(names):
        raise InvalidInputError("split_names must be unique")


class PermutationBuilder:
    """Fluent builder (reference permutation.py:21 `PermutationBuilder`)."""

    def __init__(self, table, dest: str | None = None):
        self._table = table
        self._dest = dest
        self._split = _SplitSpec()
        self._shuffle_seed: int | None = None
        self._shuffle_clump: int | None = None
        self._filter: str | None = None

    # ---- split strategies ----
    def split_random(
        self,
        *,
        seed: int = 42,
        fractions: list[float] | None = None,
        counts: list[int] | None = None,
        clump_size: int | None = None,
        split_names: list[str] | None = None,
    ) -> "PermutationBuilder":
        if fractions is not None and counts is not None:
            raise InvalidInputError("pass either fractions or counts, not both")
        if fractions is not None and abs(sum(fractions) - 1.0) > 1e-6:
            raise InvalidInputError("fractions must sum to 1")
        n_splits = len(fractions or counts or [1])
        _check_split_names(split_names, n_splits)
        self._split = _SplitSpec(
            kind="random", seed=seed, fractions=fractions, counts=counts,
            clump_size=clump_size, split_names=split_names,
        )
        return self

    def split_hash(
        self, columns: list[str], split_weights: list[int], discard_weight: int = 0,
        split_names: list[str] | None = None,
    ) -> "PermutationBuilder":
        _check_split_names(split_names, len(split_weights))
        self._split = _SplitSpec(
            kind="hash", columns=columns, split_weights=split_weights,
            discard_weight=discard_weight, split_names=split_names,
        )
        return self

    def split_sequential(self, sizes: list[int] | None = None,
                         split_names: list[str] | None = None) -> "PermutationBuilder":
        _check_split_names(split_names, len(sizes) if sizes else 1)
        self._split = _SplitSpec(kind="sequential", sizes=sizes, split_names=split_names)
        return self

    def split_calculated(self, sql: str,
                         split_names: list[str] | None = None) -> "PermutationBuilder":
        self._split = _SplitSpec(kind="calculated", sql=sql, split_names=split_names)
        return self

    # ---- other knobs ----
    def shuffle(
        self,
        seed: int = 42,
        clump_size: int | None = None,
        memory_budget_bytes: int = 100 << 20,
    ) -> "PermutationBuilder":
        """Seeded shuffle within each split. Runs under `memory_budget_
        bytes` (default 100 MiB — reference builder.rs:30): datasets
        bigger than the budget radix-spill to disk and the output is
        identical for every budget (data/shuffle.py)."""
        self._shuffle_seed = seed
        self._shuffle_clump = clump_size
        self._shuffle_budget = memory_budget_bytes
        return self

    def filter(self, predicate: str) -> "PermutationBuilder":
        self._filter = predicate
        return self

    # ---- execution ----
    def execute(self):
        ds = self._table._dataset
        spec = self._split
        need_cols: list[str] = []
        if spec.kind == "hash":
            need_cols = list(spec.columns or [])
        elif spec.kind == "calculated":
            from ..filters.eval import referenced_columns
            from ..filters.sql import parse_sql_expr

            need_cols = sorted(
                referenced_columns(parse_sql_expr(spec.sql)) & set(ds.schema.names)
            )
        base = ds.to_table(columns=need_cols, predicate=self._filter, with_row_id=True)
        row_ids = base.column(ROW_ID_COL).to_numpy().astype(np.uint64)
        n = len(row_ids)
        if n == 0:
            raise InvalidInputError("permutation over zero rows")

        split_ids = self._assign_splits(spec, base, row_ids)
        keep = split_ids >= 0
        row_ids, split_ids = row_ids[keep], split_ids[keep]

        # order rows by split then (optionally) shuffle within split —
        # the shuffle runs under a memory budget with disk spill
        # (reference shuffle.rs:32-81) and streams out in chunks
        order = np.argsort(split_ids, kind="stable")
        row_ids, split_ids = row_ids[order], split_ids[order]
        conn = self._table._conn
        name = self._dest or f"_perm_{self._table.name}_{abs(hash((spec.kind, spec.seed, self._shuffle_seed, self._filter))) % 10**8}"
        if name in conn.table_names():
            conn.drop_table(name)

        meta = None
        if spec.split_names:
            # persisted like the reference's permutation-table metadata
            # key, so Permutations can resolve splits by name later
            meta = {b"split_names": json.dumps(spec.split_names).encode()}

        def chunk_table(rids, sids):
            t = pa.table(
                {
                    ROW_ID_COL: pa.array(rids, type=pa.uint64()),
                    SPLIT_COL: pa.array(sids.astype(np.int32)),
                }
            )
            return t.replace_schema_metadata(meta) if meta else t

        if self._shuffle_seed is not None:
            from .shuffle import external_shuffle

            budget = getattr(self, "_shuffle_budget", 100 << 20)
            dest = None
            for rids, sids in external_shuffle(
                row_ids, split_ids, self._shuffle_seed, self._shuffle_clump, budget
            ):
                if dest is None:
                    dest = conn.create_table(name, chunk_table(rids, sids))
                else:
                    dest.add(chunk_table(rids, sids))
        else:
            dest = conn.create_table(name, chunk_table(row_ids, split_ids))
        return PermutationReader(dest, self._table)

    def _assign_splits(self, spec: _SplitSpec, base: pa.Table, row_ids: np.ndarray) -> np.ndarray:
        n = len(row_ids)
        if spec.kind == "none":
            return np.zeros(n, dtype=np.int64)
        if spec.kind == "random":
            rng = np.random.default_rng(spec.seed)
            clump = spec.clump_size or 1
            if clump > 1:
                nclumps = -(-n // clump)
                clump_perm = rng.permutation(nclumps)
                order = np.concatenate(
                    [np.arange(c * clump, min((c + 1) * clump, n)) for c in clump_perm]
                )
            else:
                order = rng.permutation(n)
            if spec.counts is not None:
                sizes = list(spec.counts)
                if sum(sizes) > n:
                    raise InvalidInputError(f"split counts {sizes} exceed {n} rows")
            elif spec.fractions is not None:
                sizes = [int(f * n) for f in spec.fractions]
                sizes[-1] = n - sum(sizes[:-1])
            else:
                sizes = [n]
            out = np.full(n, -1, dtype=np.int64)
            start = 0
            for s, size in enumerate(sizes):
                out[order[start : start + size]] = s
                start += size
            return out
        if spec.kind == "hash":
            weights = np.asarray(spec.split_weights, dtype=np.int64)
            total = int(weights.sum()) + spec.discard_weight
            bounds = np.cumsum(weights)
            cols = [base.column(c).to_pylist() for c in spec.columns]
            out = np.empty(n, dtype=np.int64)
            for i in range(n):
                key = "\x1f".join(str(col[i]) for col in cols)
                h = int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "little")
                bucket = h % total
                s = int(np.searchsorted(bounds, bucket, side="right"))
                out[i] = s if s < len(weights) else -1  # discard region
            return out
        if spec.kind == "sequential":
            if spec.sizes is None:
                return np.zeros(n, dtype=np.int64)
            out = np.full(n, -1, dtype=np.int64)
            start = 0
            for s, size in enumerate(spec.sizes):
                out[start : start + size] = s
                start += size
            return out
        if spec.kind == "calculated":
            arr = evaluate_expression(base, spec.sql)
            return np.asarray(arr.to_numpy(zero_copy_only=False), dtype=np.int64)
        raise InvalidInputError(f"unknown split strategy {spec.kind!r}")


class PermutationReader:
    """A materialized permutation + its base table (reference rust
    dataloader/permutation/reader.rs `PermutationReader`): random access
    into the base table through the (split, offset) addressing that the
    permutation table defines."""

    def __init__(self, perm_table, base_table):
        self.perm_table = perm_table
        self.base_table = base_table
        tbl = perm_table.to_arrow()
        self._row_ids = tbl.column(ROW_ID_COL).to_numpy().astype(np.uint64)
        self._split_ids = tbl.column(SPLIT_COL).to_numpy()
        self._split_offsets: dict[int, np.ndarray] = {}
        for s in np.unique(self._split_ids):
            self._split_offsets[int(s)] = np.nonzero(self._split_ids == s)[0]

    @property
    def num_splits(self) -> int:
        return len(self._split_offsets)

    @property
    def split_ids(self) -> list[int]:
        """Actual split ids in sorted order — split_calculated can
        produce non-contiguous ids (e.g. {0, 2, 4}), so ordinal
        accessors must resolve through this list, not assume 0..n-1."""
        return sorted(self._split_offsets)

    def split_size(self, split: int) -> int:
        return len(self._split_offsets.get(split, ()))

    def __len__(self) -> int:
        return len(self._row_ids)

    def read(
        self, split: int, offset: int, num_rows: int, columns: list[str] | None = None
    ) -> pa.Table:
        """Rows [offset, offset+num_rows) of one split, in permuted order
        (random access into the base table by row address)."""
        sel = self._split_offsets.get(split)
        if sel is None:
            raise InvalidInputError(f"no split {split}")
        window = sel[offset : offset + num_rows]
        rids = self._row_ids[window]
        return self.base_table._dataset.take_rows(rids, columns=columns)


def permutation_builder(table, dest: str | None = None) -> PermutationBuilder:
    """Entry point (reference permutation.py:234 `permutation_builder`)."""
    return PermutationBuilder(table, dest)


class PermutationSplit:
    """One split of a permutation viewed as a virtual table (reference
    permutation.py `Permutation`: num_rows/num_columns/column_names/
    shape/schema plus windowed reads)."""

    def __init__(self, perm: PermutationReader, split: int, name: str):
        self._perm = perm
        self.split = split
        self.name = name

    @property
    def schema(self) -> pa.Schema:
        return self._perm.base_table.schema

    @property
    def num_rows(self) -> int:
        return self._perm.split_size(self.split)

    @property
    def num_columns(self) -> int:
        return len(self.schema)

    @property
    def column_names(self) -> list[str]:
        return list(self.schema.names)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_rows, self.num_columns)

    def __len__(self) -> int:
        return self.num_rows

    def read(self, offset: int = 0, num_rows: int | None = None,
             columns: list[str] | None = None) -> pa.Table:
        if num_rows is None:
            num_rows = self.num_rows - offset
        return self._perm.read(self.split, offset, num_rows, columns=columns)

    def to_table(self, columns: list[str] | None = None) -> pa.Table:
        return self.read(0, self.num_rows, columns=columns)


class Permutations:
    """Splits of a permutation indexed by ordinal or by name (reference
    permutation.py:238 `Permutations`). Names come from the
    permutation table's ``split_names`` schema-metadata key; absent
    names fall back to ``split_0`` … ``split_{n-1}``."""

    def __init__(self, base_table, permutation_table):
        self.base_table = base_table
        self.permutation_table = permutation_table
        self._perm = PermutationReader(permutation_table, base_table)
        meta = permutation_table.schema.metadata or {}
        raw = meta.get(b"split_names")
        names = json.loads(raw.decode()) if raw else None
        n = self._perm.num_splits
        if names is None or len(names) != n:
            names = [f"split_{i}" for i in range(n)]
        self.split_names: list[str] = names
        self.split_dict: dict[str, int] = {nm: i for i, nm in enumerate(names)}

    @classmethod
    def from_tables(cls, base_table, permutation_table) -> "Permutations":
        return cls(base_table, permutation_table)

    def __len__(self) -> int:
        return self._perm.num_splits

    def __getitem__(self, key) -> PermutationSplit:
        if isinstance(key, str):
            if key not in self.split_dict:
                raise InvalidInputError(f"no split named {key!r}")
            idx = self.split_dict[key]
        else:
            idx = int(key)
            if not (0 <= idx < len(self)):
                raise InvalidInputError(f"split index {idx} out of range")
        # ordinal → actual split id (split_calculated ids may be sparse)
        return PermutationSplit(
            self._perm, self._perm.split_ids[idx], self.split_names[idx]
        )

    def get_by_name(self, name: str) -> "Permutation":
        """Dataset view of the named split (reference permutation.py:306)."""
        if name not in self.split_dict:
            raise InvalidInputError(f"no split named {name!r}")
        return Permutation.from_tables(
            self.base_table,
            self.permutation_table,
            self._perm.split_ids[self.split_dict[name]],
        )

    def get_by_index(self, index: int) -> "Permutation":
        """Dataset view of the index-th split (reference permutation.py:317)."""
        if not (0 <= int(index) < len(self)):
            raise InvalidInputError(f"split index {index} out of range")
        return Permutation.from_tables(
            self.base_table, self.permutation_table,
            self._perm.split_ids[int(index)],
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


# --------------------------------------------------------------------------
# Dataset view: the torch map-style / huggingface-shaped `Permutation`
# (reference python permutation.py:332-1124 `Transforms` + `Permutation`).
# --------------------------------------------------------------------------

DEFAULT_BATCH_SIZE = 100  # reference permutation.py:368


def _rows_of_dicts(batch: pa.RecordBatch):
    return batch.to_pylist()


def _dict_of_lists(batch: pa.RecordBatch):
    return batch.to_pydict()


def _dict_of_numpy(batch: pa.RecordBatch):
    return {
        name: batch.column(i).to_numpy(zero_copy_only=False)
        for i, name in enumerate(batch.schema.names)
    }


def _pandas(batch: pa.RecordBatch):
    return batch.to_pandas()


def _identity_batch(batch: pa.RecordBatch):
    return batch


def _polars(batch: pa.RecordBatch):
    # module-level (not a closure factory) so with_format('polars')
    # views stay picklable for DataLoader workers; polars imports
    # lazily inside the body like the other optional formats
    import polars as pl

    return pl.from_arrow(batch)


def _torch_numeric_columns(batch: pa.RecordBatch):
    import numpy as _np

    cols = {}
    for i, name in enumerate(batch.schema.names):
        arr = batch.column(i).to_numpy(zero_copy_only=False)
        if arr.dtype == object:  # lists/strings: keep python objects
            cols[name] = arr
        else:
            cols[name] = _np.ascontiguousarray(arr)
    return cols


def batch_to_tensor_dict(batch: pa.RecordBatch):
    """'torch' format: one dict per row mapping column → 0-D tensor, so
    the default torch collate stacks rows back into batched tensors
    (reference streaming.py batch_to_tensor_dict semantics)."""
    import torch

    cols = _torch_numeric_columns(batch)
    out = []
    for j in range(batch.num_rows):
        out.append({name: torch.as_tensor(arr[j]) for name, arr in cols.items()})
    return out


def batch_to_tensor_rows(batch: pa.RecordBatch):
    """'torch_row' format: one 1-D tensor per row (columns stacked)."""
    import numpy as _np
    import torch

    cols = list(_torch_numeric_columns(batch).values())
    mat = _np.stack([_np.asarray(c) for c in cols], axis=1)
    return [torch.as_tensor(mat[j]) for j in range(mat.shape[0])]


def batch_to_tensor(batch: pa.RecordBatch):
    """'torch_col' format: one 2-D tensor whose first dim indexes columns."""
    import numpy as _np
    import torch

    cols = list(_torch_numeric_columns(batch).values())
    return torch.as_tensor(_np.stack([_np.asarray(c) for c in cols], axis=0))


class Transforms:
    """Namespace of stock batch transforms (reference permutation.py:332)."""

    arrow2python = staticmethod(_rows_of_dicts)
    arrow2pythoncol = staticmethod(_dict_of_lists)
    arrow2numpy = staticmethod(_dict_of_numpy)
    arrow2pandas = staticmethod(_pandas)
    arrow2arrow = staticmethod(_identity_batch)
    arrow2polars = staticmethod(_polars)


def _table_pickle_state(table) -> dict:
    """Capture enough to reopen ``table`` in another process (reference
    permutation.py:371 `_table_to_pickle_state`). In-memory tables are
    serialized PER FRAGMENT — physical rows + deletion offsets under
    the original fragment ids — because permutation tables address rows
    as ``fragment_id << 32 | offset``: re-ingesting ``to_arrow()``
    through ``create_table`` would collapse fragments (wrong addresses
    on multi-fragment tables, silently shifted rows after deletes).
    Everything else reopens by connection URI."""
    conn = getattr(table, "_conn", None)
    uri = getattr(conn, "uri", "") or ""
    if uri.startswith("memory://"):
        from ..storage.fragments import read_deletion_offsets

        ds = table.to_lance()
        frags = []
        for meta in ds.manifest.fragments:
            deleted = (
                read_deletion_offsets(ds.store, ds.root, meta.deletion_file)
                if meta.deletion_file
                else None
            )
            frags.append((meta.id, ds.reader(meta.id).read_all(), deleted))
        return {
            "kind": "memory",
            "name": table.name,
            "schema": ds.manifest.schema,
            "fragments": frags,
            "max_fragment_id": ds.manifest.max_fragment_id,
            "device": str(table._device),
        }
    return {
        "kind": "local",
        "name": table.name,
        "uri": uri,
        "storage_options": getattr(conn, "storage_options", None) or None,
        "device": str(table._device),
    }


def _table_from_pickle_state(state: dict):
    from ..db import connect

    if state["kind"] == "memory":
        import uuid

        from ..storage.dataset import Dataset

        db = connect(f"memory://perm-unpickle-{uuid.uuid4().hex}", device=state["device"])
        Dataset.create_from_fragments(
            db._store,
            db._table_root(state["name"]),
            state["schema"],
            state["fragments"],
            state.get("max_fragment_id"),
        )
        return db.open_table(state["name"])
    db = connect(state["uri"], storage_options=state["storage_options"],
                 device=state["device"])
    return db.open_table(state["name"])


class Permutation:
    """A lazy, picklable dataset view over a (base table, permutation
    table, split) triple that fulfills the torch map-style Dataset
    contract and mirrors the huggingface Dataset builder surface
    (reference python permutation.py:414-1124 `Permutation`).

    Nothing is materialized: every read is a random-access `take` into
    the base table through the permutation's (split, offset) addressing,
    so views over billion-row tables are as cheap as the batches read
    from them. All ``with_*``/column builders return new views.

    Beyond the reference (which raises "not yet implemented"), this
    implements `flatten`, `unique`, and `with_repeat`.
    """

    def __init__(
        self,
        base_table,
        permutation_table=None,
        split: int = 0,
        *,
        selection: dict | None = None,
        batch_size: int = DEFAULT_BATCH_SIZE,
        transform_fn=None,
        offset: int | None = None,
        limit: int | None = None,
        repeat_times: int = 1,
        connection_factory=None,
    ):
        if base_table is None:
            raise InvalidInputError("base_table is required")
        self.base_table = base_table
        self.permutation_table = permutation_table
        self.split = int(split)
        # visible name -> source path in the base schema. Paths may use
        # dots to address struct children ("point.x"); an exact base
        # column name always wins over dotted interpretation.
        self.selection = dict(selection) if selection is not None else {
            n: n for n in base_table.schema.names
        }
        self.batch_size = batch_size
        self.transform_fn = transform_fn or Transforms.arrow2python
        self.offset = offset
        self.limit = limit
        self.repeat_times = int(repeat_times)
        self.connection_factory = connection_factory
        self._reader: PermutationReader | None = None
        self._pid: int | None = None

    # ---- construction ---------------------------------------------------
    @classmethod
    def identity(cls, table) -> "Permutation":
        """Identity view: all rows in stored order (reference :566)."""
        return cls.from_tables(table, None, None)

    @classmethod
    def from_tables(
        cls, base_table, permutation_table=None, split=None
    ) -> "Permutation":
        """View of one split of a permutation table; identity when no
        permutation table is given (reference permutation.py:573-645).
        ``split`` may be an ordinal or a name recorded in the permutation
        table's ``split_names`` schema metadata."""
        if split is not None and permutation_table is None:
            raise InvalidInputError(
                f"cannot select split {split!r} without a permutation table"
            )
        if isinstance(split, str):
            meta = permutation_table.schema.metadata or {}
            raw = meta.get(b"split_names")
            names = json.loads(raw.decode()) if raw else []
            if split not in names:
                raise InvalidInputError(
                    f"no split named {split!r} in the permutation table"
                )
            # ordinal → actual split id: split_calculated can assign
            # sparse ids, so the n-th NAME maps to the n-th id present
            import pyarrow.compute as pc

            ids = sorted(
                pc.unique(permutation_table.to_arrow().column(SPLIT_COL)).to_pylist()
            )
            ordinal = names.index(split)
            if ordinal >= len(ids):
                raise InvalidInputError(
                    f"split {split!r} (ordinal {ordinal}) has no rows"
                )
            split = ids[ordinal]
        return cls(base_table, permutation_table, int(split or 0))

    # ---- reader lifecycle (pickle / fork safe) --------------------------
    def _ensure_open(self) -> None:
        import os as _os

        pid = _os.getpid()
        if self._pid == pid and (
            self._reader is not None or self.permutation_table is None
        ):
            return
        if self.permutation_table is not None:
            self._reader = PermutationReader(self.permutation_table, self.base_table)
        self._pid = pid

    def _split_len(self) -> int:
        self._ensure_open()
        if self._reader is not None:
            return self._reader.split_size(self.split)
        return self.base_table.count_rows()

    def _window(self) -> tuple[int, int]:
        """(start, n) of the skip/take window inside the split."""
        total = self._split_len()
        start = min(self.offset or 0, total)
        n = total - start
        if self.limit is not None:
            n = min(n, self.limit)
        return start, n

    # ---- schema / source resolution -------------------------------------
    def _resolve(self, src: str) -> tuple[str, tuple[str, ...]]:
        """Split a source path into (base column, struct-field path)."""
        names = set(self.base_table.schema.names)
        if src in names or src == ROW_ID_COL:
            return src, ()
        parts = src.split(".")
        for i in range(len(parts) - 1, 0, -1):
            head = ".".join(parts[:i])
            if head in names:
                return head, tuple(parts[i:])
        raise InvalidInputError(f"column {src!r} does not exist in the base table")

    def _type_of(self, src: str) -> pa.DataType:
        base, path = self._resolve(src)
        if base == ROW_ID_COL:
            return pa.uint64()
        t = self.base_table.schema.field(base).type
        for part in path:
            if not pa.types.is_struct(t):
                raise InvalidInputError(f"{src!r}: {part!r} is not a struct field")
            t = t.field(part).type
        return t

    @property
    def schema(self) -> pa.Schema:
        return pa.schema(
            [pa.field(vis, self._type_of(src)) for vis, src in self.selection.items()]
        )

    @property
    def num_columns(self) -> int:
        return len(self.selection)

    @property
    def num_rows(self) -> int:
        _, n = self._window()
        return n * self.repeat_times

    @property
    def column_names(self) -> list[str]:
        return list(self.selection.keys())

    @property
    def shape(self) -> tuple[int, int]:
        return self.num_rows, self.num_columns

    def __len__(self) -> int:
        return self.num_rows

    # ---- builders --------------------------------------------------------
    def _copy(self, **overrides) -> "Permutation":
        import copy as _copy

        new = _copy.copy(self)
        for k, v in overrides.items():
            setattr(new, k, v)
        return new

    def _with_selection(self, selection: dict) -> "Permutation":
        return self._copy(selection=selection)

    def with_batch_size(self, batch_size: int) -> "Permutation":
        return self._copy(batch_size=int(batch_size))

    def with_connection_factory(self, connection_factory) -> "Permutation":
        """Use ``connection_factory(table_name) -> table`` to reopen the
        base table after unpickling in a worker process (reference
        permutation.py:489). The factory must itself be picklable."""
        if connection_factory is None:
            raise InvalidInputError("connection_factory is required")
        return self._copy(connection_factory=connection_factory)

    def with_skip(self, skip: int) -> "Permutation":
        """Skip the first `skip` rows of the split (before any repeat)."""
        return self._copy(offset=int(skip))

    skip = with_skip  # huggingface-compat alias (reference deprecates)

    def with_take(self, limit: int) -> "Permutation":
        """Keep at most `limit` rows (after any skip, before repeat)."""
        return self._copy(limit=int(limit))

    take = with_take

    def with_repeat(self, times: int) -> "Permutation":
        """Repeat the (skip/take-windowed) rows `times` times."""
        if int(times) < 1:
            raise InvalidInputError("repeat times must be >= 1")
        return self._copy(repeat_times=int(times))

    repeat = with_repeat

    def select_columns(self, columns: list[str]) -> "Permutation":
        """Refine the selection; `_rowid` may be selected explicitly."""
        if not columns:
            raise InvalidInputError("must select at least one column")
        new_selection = {}
        for name in columns:
            src = self.selection.get(name)
            if src is None:
                if name == ROW_ID_COL:
                    src = ROW_ID_COL
                else:
                    raise InvalidInputError(
                        f"cannot select column {name!r}: it does not exist"
                    )
            new_selection[name] = src
        return self._with_selection(new_selection)

    def remove_columns(self, columns: list[str]) -> "Permutation":
        """Drop columns from the view; missing names are ignored."""
        if columns is None:
            raise InvalidInputError("columns is required")
        drop = set(columns)
        new_selection = {
            k: v for k, v in self.selection.items() if k not in drop
        }
        if not new_selection:
            raise InvalidInputError("cannot remove all columns")
        return self._with_selection(new_selection)

    def rename_column(self, old_name: str, new_name: str) -> "Permutation":
        if old_name not in self.selection:
            raise InvalidInputError(
                f"cannot rename {old_name!r}: it does not exist"
            )
        if new_name in self.selection:
            raise InvalidInputError(
                f"cannot rename {old_name!r} to {new_name!r}: name already exists"
            )
        new_selection = {}
        for k, v in self.selection.items():  # preserve column order
            new_selection[new_name if k == old_name else k] = v
        return self._with_selection(new_selection)

    def rename_columns(self, column_map: dict) -> "Permutation":
        new = self
        for old, nw in column_map.items():
            new = new.rename_column(old, nw)
        return new

    def flatten(self) -> "Permutation":
        """Flatten one level of struct columns into dotted child columns.
        Pure selection rewrite — happens at read time, no data is copied
        (implemented; the reference raises "not yet implemented")."""
        new_selection = {}
        for vis, src in self.selection.items():
            t = self._type_of(src)
            if pa.types.is_struct(t) and t.num_fields:
                for i in range(t.num_fields):
                    child = t.field(i).name
                    new_selection[f"{vis}.{child}"] = f"{src}.{child}"
            else:
                new_selection[vis] = src
        return self._with_selection(new_selection)

    def with_transform(self, transform) -> "Permutation":
        """Custom per-batch transform: RecordBatch -> anything."""
        if transform is None:
            raise InvalidInputError("transform is required")
        return self._copy(transform_fn=transform)

    def with_format(self, format: str) -> "Permutation":
        """Stock batch formats (reference permutation.py:946): python,
        python_col, numpy, pandas, arrow, polars, torch, torch_row,
        torch_col."""
        table = {
            "python": Transforms.arrow2python,
            "python_col": Transforms.arrow2pythoncol,
            "numpy": Transforms.arrow2numpy,
            "pandas": Transforms.arrow2pandas,
            "arrow": Transforms.arrow2arrow,
            "torch": batch_to_tensor_dict,
            "torch_row": batch_to_tensor_rows,
            "torch_col": batch_to_tensor,
        }
        if format == "polars":
            return self.with_transform(Transforms.arrow2polars)
        if format not in table:
            raise InvalidInputError(f"invalid format: {format!r}")
        return self.with_transform(table[format])

    # ---- reads -----------------------------------------------------------
    def _fetch(self, view_offsets) -> pa.RecordBatch:
        """Rows at the given view offsets, projected to the selection."""
        self._ensure_open()
        start, n = self._window()
        offs = np.asarray(view_offsets, dtype=np.int64)
        if len(offs) and (offs.min() < 0 or offs.max() >= n * self.repeat_times):
            raise InvalidInputError(
                f"offset out of range [0, {n * self.repeat_times})"
            )
        offs = (offs % max(n, 1)) + start

        resolved = {vis: self._resolve(src) for vis, src in self.selection.items()}
        src_cols = sorted({b for b, _ in resolved.values() if b != ROW_ID_COL})
        need_rowid = any(b == ROW_ID_COL for b, _ in resolved.values())

        ds = self.base_table._dataset
        if self._reader is not None:
            sel = self._reader._split_offsets.get(self.split)
            rids = self._reader._row_ids[sel[offs]] if sel is not None else offs
            tbl = ds.take_rows(rids, columns=src_cols)
        else:
            rids = ds.offsets_to_row_ids(offs) if need_rowid else None
            tbl = ds.take_offsets(offs, columns=src_cols)

        import pyarrow.compute as pc

        arrays, fields = [], []
        for vis, src in self.selection.items():
            base, path = resolved[vis]
            if base == ROW_ID_COL:
                col = pa.chunked_array([pa.array(rids, type=pa.uint64())])
            else:
                col = tbl.column(base)
                if path:
                    col = pc.struct_field(col, list(path))
            arrays.append(col)
            fields.append(pa.field(vis, col.type))
        out = pa.table(arrays, schema=pa.schema(fields)).combine_chunks()
        batches = out.to_batches()
        if not batches:
            return pa.RecordBatch.from_pylist([], schema=out.schema)
        return batches[0]

    def take_offsets(self, offsets: list[int]):
        """Rows by view offset, through the current transform."""
        return self.transform_fn(self._fetch(offsets))

    def __getitem__(self, index: int):
        return self.take_offsets([index])

    def __getitems__(self, indices: list[int]):
        # torch's fetcher prefers this batched form when present
        return self.take_offsets(list(indices))

    def iter(self, batch_size: int, skip_last_batch: bool = False):
        """Iterate the view in transform-formatted batches."""
        total = self.num_rows
        for lo in range(0, total, batch_size):
            hi = min(lo + batch_size, total)
            if skip_last_batch and hi - lo < batch_size:
                return
            yield self.transform_fn(self._fetch(np.arange(lo, hi)))

    def __iter__(self):
        return self.iter(self.batch_size, skip_last_batch=True)

    def unique(self, column: str) -> list:
        """Distinct values of one visible column, in first-seen order
        (implemented; the reference raises "not yet implemented")."""
        import pyarrow.compute as pc

        if column not in self.selection and column != ROW_ID_COL:
            raise InvalidInputError(f"no column {column!r} in the view")
        view = self.select_columns([column]).with_transform(
            Transforms.arrow2arrow
        )
        chunks = []
        for batch in view.iter(max(self.batch_size, 4096)):
            chunks.append(batch.column(0))
        if not chunks:
            return []
        return pc.unique(pa.chunked_array(chunks)).to_pylist()

    def to_table(self) -> pa.Table:
        """Materialize the whole view as a pyarrow Table (convenience)."""
        return pa.Table.from_batches(
            list(self.with_transform(Transforms.arrow2arrow).iter(
                max(self.batch_size, 4096))),
            schema=self.schema,
        )

    # ---- pickling (DataLoader worker processes) --------------------------
    def __getstate__(self) -> dict:
        state = {
            "base_table_name": self.base_table.name,
            "permutation_data": (
                self.permutation_table.to_arrow()
                if self.permutation_table is not None
                else None
            ),
            "permutation_meta": (
                dict(self.permutation_table.schema.metadata or {})
                if self.permutation_table is not None
                else None
            ),
            "split": self.split,
            "selection": self.selection,
            "batch_size": self.batch_size,
            "transform_fn": self.transform_fn,
            "offset": self.offset,
            "limit": self.limit,
            "repeat_times": self.repeat_times,
            "connection_factory": self.connection_factory,
        }
        if self.connection_factory is None:
            state["base_table_state"] = _table_pickle_state(self.base_table)
        return state

    def __setstate__(self, state: dict) -> None:
        factory = state["connection_factory"]
        if factory is not None:
            base_table = factory(state["base_table_name"])
        else:
            base_table = _table_from_pickle_state(state["base_table_state"])
        permutation_table = None
        if state["permutation_data"] is not None:
            import uuid

            from ..db import connect

            data = state["permutation_data"]
            if state["permutation_meta"]:
                data = data.replace_schema_metadata(state["permutation_meta"])
            db = connect(f"memory://perm-unpickle-{uuid.uuid4().hex}",
                         device=str(base_table._device))
            permutation_table = db.create_table("permutation", data)
        self.base_table = base_table
        self.permutation_table = permutation_table
        self.split = state["split"]
        self.selection = state["selection"]
        self.batch_size = state["batch_size"]
        self.transform_fn = state["transform_fn"]
        self.offset = state["offset"]
        self.limit = state["limit"]
        self.repeat_times = state["repeat_times"]
        self.connection_factory = factory
        self._reader = None
        self._pid = None
