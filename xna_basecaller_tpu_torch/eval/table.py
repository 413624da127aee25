"""A small column table in place of pandas, which the machine with the card
does not have: what ``eval/analyze.py`` and
``tools/consolidate_ub_validation.py`` of the JAX package do with
DataFrames, with numpy and the ``csv`` module, writing the same CSV text.

A column is a numpy array whose dtype follows pandas' inference from the
values it was made of (all bool: bool; all int: int64; numbers with
missing values or floats: float64, None as NaN; anything else: object),
and keeps that dtype when rows are selected, as a DataFrame's column does:
the dtype decides how ``to_csv`` writes a value (``float_format`` and
``na_rep`` for floats, ``str`` for ints, ``True``/``False`` for bools).
Means are taken in pandas' order of operations, so that the numbers equal
pandas' bit for bit: ``series_mean`` as ``Series.mean`` (NaN as 0 in a
pairwise numpy sum, over the count of the others) and ``group_mean`` as
the mean of a ``groupby`` (a compensated sum in row order, NaN skipped).
"""

from __future__ import annotations

import csv
import math
import numbers

import numpy as np


def column(values) -> np.ndarray:
    """A column of ``values`` with the dtype pandas would give it."""
    if isinstance(values, np.ndarray):
        return values
    vals = list(values)
    if vals and all(isinstance(v, (bool, np.bool_)) for v in vals):
        return np.array(vals, bool)
    ints = [isinstance(v, numbers.Integral)
            and not isinstance(v, (bool, np.bool_)) for v in vals]
    if vals and all(ints):
        return np.array(vals, np.int64)
    if vals and all(v is None or isinstance(v, numbers.Real) for v in vals) \
            and not any(isinstance(v, (bool, np.bool_)) for v in vals):
        return np.array([np.nan if v is None else v for v in vals],
                        np.float64)
    out = np.empty(len(vals), object)
    for i, v in enumerate(vals):
        out[i] = v
    return out


def series_mean(values) -> float:
    """``pd.Series(values).mean()``: NaN skipped, NaN when none is left."""
    v = np.asarray(values, np.float64)
    mask = np.isnan(v)
    count = v.size - int(mask.sum())
    if count == 0:
        return float("nan")
    return float(np.where(mask, 0.0, v).sum() / count)


def group_mean(values) -> float:
    """The mean ``groupby(...).mean()`` gives a group of ``values`` (in
    row order): a compensated (Kahan) sum of the non-NaN values over their
    count; NaN when none is left."""
    total = comp = 0.0
    n = 0
    for x in values:
        x = float(x)
        if x != x:
            continue
        n += 1
        y = x - comp
        t = total + y
        comp = (t - total) - y
        total = t
    return total / n if n else float("nan")


def _is_na(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


class Table:
    """Columns of equal length, in order, and optionally an index (a list
    of row labels, with a name per level)."""

    def __init__(self, columns: dict | None = None, index=None,
                 index_names=None):
        self.cols = {k: column(v) for k, v in (columns or {}).items()}
        self.index = list(index) if index is not None else None
        self.index_names = list(index_names or [])

    @classmethod
    def from_records(cls, records) -> "Table":
        """As ``pd.DataFrame(records)``: the union of the records' keys,
        in order of first appearance; a missing value is None (NaN)."""
        records = list(records)
        keys: dict = {}
        for r in records:
            keys.update(dict.fromkeys(r))
        return cls({k: [r.get(k) for r in records] for k in keys})

    def __len__(self) -> int:
        return len(next(iter(self.cols.values()))) if self.cols else 0

    @property
    def empty(self) -> bool:
        return not self.cols or len(self) == 0

    def __contains__(self, name) -> bool:
        return name in self.cols

    def __getitem__(self, name) -> np.ndarray:
        return self.cols[name]

    def __setitem__(self, name, values):
        self.cols[name] = column(values)

    @property
    def columns(self) -> list:
        return list(self.cols)

    def rows(self, which) -> "Table":
        """The rows selected by a boolean mask or by row positions, in
        order, with their dtypes (and index labels)."""
        which = np.asarray(which)
        if which.dtype == bool:
            which = np.flatnonzero(which)
        which = which.astype(np.int64)
        out = Table(index_names=self.index_names)
        out.cols = {k: v[which] for k, v in self.cols.items()}
        if self.index is not None:
            out.index = [self.index[i] for i in which]
        return out

    def join(self, other: "Table") -> "Table":
        """The columns of both, side by side (``pd.concat(axis=1)``)."""
        out = self.rows(np.arange(len(self)))
        out.cols.update(other.cols)
        return out

    def records(self):
        """Each row as a dict of Python scalars (``iterrows``)."""
        lists = {k: v.tolist() for k, v in self.cols.items()}
        for i in range(len(self)):
            yield {k: v[i] for k, v in lists.items()}

    def groups(self, keys) -> dict:
        """{key tuple: row positions in order}, the keys sorted, as
        ``groupby(keys)`` visits them."""
        out: dict = {}
        for i, key in enumerate(zip(*(self.cols[k].tolist() for k in keys))):
            out.setdefault(key, []).append(i)
        return {k: np.asarray(out[k]) for k in sorted(out)}

    @property
    def loc(self):
        """``t.loc[label, column]``: the value of the row labelled
        ``label`` (the first such) in ``column``."""
        table = self

        class _Loc:
            def __getitem__(self, key):
                label, name = key
                return table.cols[name][table.index.index(label)]
        return _Loc()

    def to_csv(self, path: str, index: bool = False, float_format=None,
               na_rep: str = "", header: bool = True):
        """Write the table as ``DataFrame.to_csv`` writes it."""
        names = (self.index_names if index else []) + self.columns
        cols = [self._formatted(v, float_format, na_rep)
                for v in self.cols.values()]
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh, lineterminator="\n")
            if header:
                w.writerow(names)
            for i in range(len(self)):
                label = []
                if index:
                    label = self.index[i]
                    label = [str(x) for x in (
                        label if isinstance(label, tuple) else (label,))]
                w.writerow(label + [c[i] for c in cols])

    @staticmethod
    def _formatted(values: np.ndarray, float_format, na_rep) -> list:
        kind = values.dtype.kind
        if kind == "f":
            fmt = float_format or repr
            return [na_rep if math.isnan(v) else fmt(v)
                    for v in values.tolist()]
        if kind in "iub":
            return [str(v) for v in values.tolist()]
        return [na_rep if _is_na(v) else str(v) for v in values.tolist()]

    def to_string(self, digits: int = 1) -> str:
        """A plain text view (index and columns), floats rounded."""
        names = self.index_names + self.columns
        rows = [names]
        for i in range(len(self)):
            label = self.index[i] if self.index is not None else i
            rows.append([str(label)] + [
                f"{v:.{digits}f}" if isinstance(v, float) else str(v)
                for v in (c[i].item() if hasattr(c[i], "item") else c[i]
                          for c in self.cols.values())])
        widths = [max(len(r[j]) for r in rows) for j in range(len(names))]
        return "\n".join("  ".join(s.rjust(w) for s, w in zip(r, widths))
                         for r in rows)
