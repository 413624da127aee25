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
``read_csv`` reads a table as ``pd.read_csv`` types it (the same rules on
the text: ints int64, ints or floats with blanks float64, True/False bool,
anything else object with NaN for pandas' missing markers); ``concat``
stacks tables as ``pd.concat`` does; ``to_string`` prints pandas'
``to_string(index=False)``.  A path that ends in ``.gz`` is read and
written through gzip, as pandas infers it.
"""

from __future__ import annotations

import csv
import gzip
import math
import numbers
import re

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


def isna(values: np.ndarray) -> np.ndarray:
    """``Series.isna()``: NaN in a float column, None or NaN in an object
    one, nothing in others."""
    if values.dtype.kind == "f":
        return np.isnan(values)
    if values.dtype.kind == "O":
        return np.array([_is_na(v) for v in values.tolist()], bool)
    return np.zeros(len(values), bool)


def _open_text(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode + "t", newline="")
    return open(path, mode, newline="")


# pandas' default missing-value markers (``pandas._libs.parsers``)
_NA_TEXT = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_INT_TEXT = re.compile(r"[+-]?[0-9]+\Z")
_FLOAT_TEXT = re.compile(
    r"[+-]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?\Z"
    r"|[+-]?(inf|infinity)\Z", re.IGNORECASE)
_BOOL_TEXT = {"True": True, "TRUE": True, "true": True,
              "False": False, "FALSE": False, "false": False}


def parse_column(texts: list[str]) -> np.ndarray:
    """A column of CSV fields typed as ``pd.read_csv`` types it."""
    na = [t in _NA_TEXT for t in texts]
    given = [t for t, m in zip(texts, na) if not m]
    if not given:
        return np.full(len(texts), np.nan)
    if all(_INT_TEXT.match(t) for t in given):
        if not any(na):
            return np.array([int(t) for t in texts], np.int64)
        return np.array([np.nan if m else float(int(t))
                         for t, m in zip(texts, na)])
    if all(_FLOAT_TEXT.match(t) for t in given):
        return np.array([np.nan if m else float(t)
                         for t, m in zip(texts, na)])
    if all(t in _BOOL_TEXT for t in given) and not any(na):
        return np.array([_BOOL_TEXT[t] for t in texts], bool)
    out = np.empty(len(texts), object)
    for i, (t, m) in enumerate(zip(texts, na)):
        out[i] = np.nan if m else _BOOL_TEXT.get(t, t)
    return out


def read_csv(path: str, sep: str = ",", index_col: int | None = None):
    """``pd.read_csv(path, sep=sep, index_col=index_col)`` as a ``Table``:
    blank header fields named ``Unnamed: i``, repeated names ``name.1``,
    each column typed by ``parse_column``; ``index_col=0`` makes the first
    column the row labels."""
    with _open_text(path, "r") as fh:
        rows = list(csv.reader(fh, delimiter=sep))
    header, body = rows[0], [r for r in rows[1:] if r]
    names, seen = [], {}
    for i, h in enumerate(header):
        name = h or f"Unnamed: {i}"
        if name in seen:
            seen[name] += 1
            name = f"{name}.{seen[name]}"
        seen.setdefault(name, 0)
        names.append(name)
    cols = {n: parse_column([r[i] if i < len(r) else "" for r in body])
            for i, n in enumerate(names)}
    if index_col is None:
        return Table(cols)
    if index_col != 0:
        raise ValueError("read_csv takes index_col None or 0")
    first = names[0]
    index = cols.pop(first).tolist()
    return Table(cols, index=index, index_names=[header[0] or None])


def concat(tables: list["Table"]) -> "Table":
    """``pd.concat(tables).reset_index(drop=True)``: the union of the
    columns in order of first appearance; a column that a table lacks is
    NaN there, so that ints become float64 and bools or text object."""
    names: dict = {}
    for t in tables:
        names.update(dict.fromkeys(t.columns))
    out = Table()
    for name in names:
        parts = [t.cols.get(name) for t in tables]
        kinds = {p.dtype.kind for p in parts if p is not None}
        if all(p is not None for p in parts) and len(
                {p.dtype for p in parts}) == 1:
            out.cols[name] = np.concatenate(parts)
        elif kinds <= {"i", "u", "f"}:
            out.cols[name] = np.concatenate([
                p.astype(np.float64) if p is not None
                else np.full(len(t), np.nan) for p, t in zip(parts, tables)])
        else:
            col = np.empty(sum(len(t) for t in tables), object)
            at = 0
            for p, t in zip(parts, tables):
                col[at:at + len(t)] = (p.tolist() if p is not None
                                       else [np.nan] * len(t))
                at += len(t)
            out.cols[name] = col
    return out


def _trim_zeros(cells: list[str]) -> list[str]:
    """Trailing zeros trimmed equally from every number, one kept after
    the point (pandas' ``_trim_zeros_float``)."""
    while cells and all(c.endswith("0") for c in cells):
        cells = [c[:-1] for c in cells]
    return [c + "0" if c.endswith(".") else c for c in cells]


def _float_cells(values: np.ndarray) -> list[str]:
    """pandas' float column text: six decimals, trimmed, or scientific
    where a number is small or a large one makes the column too wide;
    NaN as ``NaN``."""
    finite = values[~np.isnan(values)]
    absv = np.abs(finite)
    cells = _trim_zeros([f"{v:.6f}" for v in finite.tolist()])
    width = max([0, *(len(c) for c in cells)]
                + [3] * int(np.isnan(values).any()))
    if ((absv < 1e-6) & (absv > 0)).any() or (width > 12
                                              and (absv > 1e6).any()):
        cells = [f"{v:.6e}" for v in finite.tolist()]
    it = iter(cells)
    return ["NaN" if math.isnan(v) else next(it) for v in values.tolist()]


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
        with _open_text(path, "w") as fh:
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

    def round(self, decimals: int = 0) -> "Table":
        """``DataFrame.round``: float columns by ``np.round``."""
        out = self.rows(np.arange(len(self)))
        out.cols = {k: np.round(v, decimals) if v.dtype.kind == "f" else v
                    for k, v in out.cols.items()}
        return out

    def to_string(self) -> str:
        """The text of pandas' ``to_string(index=False)``: each column
        right-justified to its widest cell, a numeric column's header
        (bools included) one space wider, columns one space apart."""
        out = []
        for name, v in self.cols.items():
            if v.dtype.kind == "f":
                cells = _float_cells(v)
            else:
                cells = ["NaN" if _is_na(x) else str(x) for x in v.tolist()]
            head = (" " if v.dtype.kind in "iufb" else "") + str(name)
            width = max([len(head)] + [len(c) for c in cells])
            out.append([head.rjust(width)] + [c.rjust(width) for c in cells])
        return "\n".join(" ".join(col[i] for col in out)
                         for i in range(len(self) + 1))
