"""Numeric/label attribute indexes (paper Table 1: B-Tree, Sorted List).

Used by attribute filtering: expressions like ``price < 100 AND label ==
'book'`` are resolved to a row bitmap which the vector kernels consume as a
validity mask.  A sorted-list index gives O(log n) range resolution; label
(categorical) fields use posting bitmaps.
"""

from __future__ import annotations

import io

import numpy as np

# Comparison-op vocabulary shared by the indexes and FilterExpr leaves.
_OP_FNS = {
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
}


class SortedListIndex:
    """Sorted projection of a numeric column with binary-search ranges."""

    KIND = "sorted_list"

    def __init__(self, values: np.ndarray):
        self.n = len(values)
        self.order = np.argsort(values, kind="stable")
        self.sorted_vals = np.asarray(values)[self.order]

    def range_mask(self, lo=None, hi=None, lo_open=False, hi_open=False) -> np.ndarray:
        left = 0
        right = self.n
        if lo is not None:
            left = np.searchsorted(self.sorted_vals, lo, side="right" if lo_open else "left")
        if hi is not None:
            right = np.searchsorted(self.sorted_vals, hi, side="left" if hi_open else "right")
        mask = np.zeros(self.n, dtype=bool)
        if right > left:
            mask[self.order[left:right]] = True
        return mask

    def _bounds(self, op: str, value) -> tuple[int, int]:
        """[left, right) slice of the sorted projection matching ``op value``
        (``ne`` callers complement the ``eq`` interval)."""
        if op in ("eq", "ne"):
            return (
                int(np.searchsorted(self.sorted_vals, value, side="left")),
                int(np.searchsorted(self.sorted_vals, value, side="right")),
            )
        if op == "lt":
            return 0, int(np.searchsorted(self.sorted_vals, value, side="left"))
        if op == "le":
            return 0, int(np.searchsorted(self.sorted_vals, value, side="right"))
        if op == "gt":
            return int(np.searchsorted(self.sorted_vals, value, side="right")), self.n
        if op == "ge":
            return int(np.searchsorted(self.sorted_vals, value, side="left")), self.n
        raise ValueError(f"unknown op {op!r}")

    def op_mask(self, op: str, value) -> np.ndarray:
        left, right = self._bounds(op, value)
        mask = np.zeros(self.n, dtype=bool)
        if right > left:
            mask[self.order[left:right]] = True
        return ~mask if op == "ne" else mask

    def op_count(self, op: str, value) -> int:
        left, right = self._bounds(op, value)
        hit = max(0, right - left)
        return self.n - hit if op == "ne" else hit

    def _state(self) -> dict[str, np.ndarray]:
        return {"order": self.order, "sorted_vals": self.sorted_vals}

    @classmethod
    def _from_state(cls, state: dict[str, np.ndarray]) -> "SortedListIndex":
        idx = cls.__new__(cls)
        idx.order = state["order"]
        idx.sorted_vals = state["sorted_vals"]
        idx.n = len(idx.order)
        return idx

    def save(self) -> bytes:
        return _dump_attr(self.KIND, self._state())


class LabelIndex:
    """Posting bitmaps per distinct label value (dictionary-encoded)."""

    KIND = "label"

    def __init__(self, values: np.ndarray):
        vals = np.asarray(values)
        self.n = len(vals)
        self.keys, self.codes = np.unique(vals, return_inverse=True)
        self._finish()

    def _finish(self) -> None:
        self.codes = self.codes.astype(np.int32)
        self.counts = np.bincount(self.codes, minlength=len(self.keys))
        self.postings: dict[object, np.ndarray] = {}
        for i, k in enumerate(self.keys):
            self.postings[k.item() if hasattr(k, "item") else k] = self.codes == i

    def eq_mask(self, value) -> np.ndarray:
        return self.postings.get(value, np.zeros(self.n, dtype=bool)).copy()

    def in_mask(self, values) -> np.ndarray:
        mask = np.zeros(self.n, dtype=bool)
        for v in values:
            mask |= self.postings.get(v, False)
        return mask

    def _key_mask(self, op: str, value) -> np.ndarray:
        with np.errstate(all="ignore"):
            return np.asarray(_OP_FNS[op](self.keys, value), dtype=bool)

    def op_mask(self, op: str, value) -> np.ndarray:
        km = self._key_mask(op, value)
        if km.shape != self.keys.shape:  # scalar broadcast (e.g. no match)
            km = np.broadcast_to(km, self.keys.shape)
        return km[self.codes] if len(self.keys) else np.zeros(self.n, dtype=bool)

    def op_count(self, op: str, value) -> int:
        km = self._key_mask(op, value)
        if km.shape != self.keys.shape:
            km = np.broadcast_to(km, self.keys.shape)
        return int(self.counts[km].sum()) if len(self.keys) else 0

    def _state(self) -> dict[str, np.ndarray]:
        return {"keys": self.keys, "codes": self.codes}

    @classmethod
    def _from_state(cls, state: dict[str, np.ndarray]) -> "LabelIndex":
        idx = cls.__new__(cls)
        idx.keys = state["keys"]
        idx.codes = state["codes"]
        idx.n = len(idx.codes)
        idx._finish()
        return idx

    def save(self) -> bytes:
        return _dump_attr(self.KIND, self._state())


_ATTR_KINDS = {SortedListIndex.KIND: SortedListIndex, LabelIndex.KIND: LabelIndex}
_ATTR_META = ("kind",)


def _dump_attr(kind: str, state: dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, kind=np.bytes_(kind.encode()), **state)
    return buf.getvalue()


def build_attribute_index(values: np.ndarray):
    """Numeric 1-D columns get a sorted-list index, everything else postings."""
    vals = np.asarray(values)
    if vals.ndim != 1:
        raise ValueError(f"attribute index needs a 1-D column, got shape {vals.shape}")
    if np.issubdtype(vals.dtype, np.number):
        return SortedListIndex(vals)
    return LabelIndex(vals)


def load_attribute_index(data: bytes):
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        kind = bytes(z["kind"]).decode()
        cls = _ATTR_KINDS.get(kind)
        if cls is None:
            raise ValueError(f"unknown attribute index kind {kind!r}")
        state = {k: z[k] for k in z.files if k not in _ATTR_META}
        return cls._from_state(state)


# ---------------------------------------------------------------------------
# A tiny filter-expression evaluator: supports comparisons on numeric fields,
# equality on labels, AND/OR/NOT.  Grammar kept deliberately small (Manu's
# filtering surface), parsed with Python's ast over a restricted node set.
# ---------------------------------------------------------------------------

import ast


class FilterExpr:
    """Compile ``"price < 100 and label == 'book'"`` into a mask evaluator."""

    _CMP = {
        ast.Lt: lambda a, b: a < b,
        ast.LtE: lambda a, b: a <= b,
        ast.Gt: lambda a, b: a > b,
        ast.GtE: lambda a, b: a >= b,
        ast.Eq: lambda a, b: a == b,
        ast.NotEq: lambda a, b: a != b,
    }

    def __init__(self, expr: str):
        self.expr = expr
        self.tree = ast.parse(expr, mode="eval").body
        self._validate(self.tree)

    def _validate(self, node) -> None:
        ok = (
            ast.BoolOp, ast.And, ast.Or, ast.UnaryOp, ast.Not, ast.Compare,
            ast.Name, ast.Load, ast.Constant, ast.Lt, ast.LtE, ast.Gt,
            ast.GtE, ast.Eq, ast.NotEq,
        )
        for child in ast.walk(node):
            if not isinstance(child, ok):
                raise ValueError(f"unsupported filter syntax: {ast.dump(child)}")

    def evaluate(self, columns: dict[str, np.ndarray], n: int) -> np.ndarray:
        def ev(node) -> np.ndarray:
            if isinstance(node, ast.BoolOp):
                masks = [ev(v) for v in node.values]
                out = masks[0]
                for m in masks[1:]:
                    out = out & m if isinstance(node.op, ast.And) else out | m
                return out
            if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
                return ~ev(node.operand)
            if isinstance(node, ast.Compare):
                if len(node.ops) != 1:
                    raise ValueError("chained comparisons unsupported")
                left, right = node.left, node.comparators[0]
                name_node, const_node, flip = (
                    (left, right, False)
                    if isinstance(left, ast.Name)
                    else (right, left, True)
                )
                if not isinstance(name_node, ast.Name) or not isinstance(const_node, ast.Constant):
                    raise ValueError("comparison must be field <op> constant")
                col = columns.get(name_node.id)
                if col is None:
                    raise KeyError(f"unknown filter field '{name_node.id}'")
                op = type(node.ops[0])
                fn = self._CMP[op]
                if flip:  # const <op> field  ->  field <flipped-op> const
                    flipped = {ast.Lt: ast.Gt, ast.LtE: ast.GtE,
                               ast.Gt: ast.Lt, ast.GtE: ast.LtE,
                               ast.Eq: ast.Eq, ast.NotEq: ast.NotEq}[op]
                    fn = self._CMP[flipped]
                return np.asarray(fn(col, const_node.value))
            raise ValueError(f"unsupported node {node!r}")

        mask = ev(self.tree)
        if mask.shape != (n,):
            mask = np.broadcast_to(mask, (n,)).copy()
        return mask

    # -- attribute-index resolution -----------------------------------------

    _OPSTR = {
        ast.Lt: "lt", ast.LtE: "le", ast.Gt: "gt",
        ast.GtE: "ge", ast.Eq: "eq", ast.NotEq: "ne",
    }
    _FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}

    def fields(self) -> set[str]:
        return {node.id for node in ast.walk(self.tree) if isinstance(node, ast.Name)}

    def _leaf(self, node: ast.Compare) -> tuple[str, str, object]:
        """Normalize a comparison to ``(field, op, constant)``."""
        if len(node.ops) != 1:
            raise ValueError("chained comparisons unsupported")
        left, right = node.left, node.comparators[0]
        name_node, const_node, flip = (
            (left, right, False) if isinstance(left, ast.Name) else (right, left, True)
        )
        if not isinstance(name_node, ast.Name) or not isinstance(const_node, ast.Constant):
            raise ValueError("comparison must be field <op> constant")
        op = self._OPSTR[type(node.ops[0])]
        if flip:
            op = self._FLIP[op]
        return name_node.id, op, const_node.value

    def bitmap(self, attr_indexes: dict[str, object], n: int) -> np.ndarray:
        """Exact row bitmap resolved through per-field attribute indexes.

        Bit-for-bit identical to ``evaluate`` over the same rows; raises
        ``KeyError`` when a referenced field has no index (callers fall back
        to row-wise evaluation)."""
        def ev(node) -> np.ndarray:
            if isinstance(node, ast.BoolOp):
                masks = [ev(v) for v in node.values]
                out = masks[0]
                for m in masks[1:]:
                    out = out & m if isinstance(node.op, ast.And) else out | m
                return out
            if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
                return ~ev(node.operand)
            if isinstance(node, ast.Compare):
                field, op, value = self._leaf(node)
                idx = attr_indexes.get(field)
                if idx is None:
                    raise KeyError(f"no attribute index for field '{field}'")
                return idx.op_mask(op, value)
            raise ValueError(f"unsupported node {node!r}")

        mask = ev(self.tree)
        if mask.shape != (n,):
            mask = np.broadcast_to(mask, (n,)).copy()
        return mask

    def estimate_selectivity(self, attr_indexes: dict[str, object], n: int) -> float:
        """Cheap selectivity estimate from exact leaf counts combined under
        an independence assumption (and: a*b, or: 1-(1-a)(1-b), not: 1-a).
        Leaves without an index estimate 0.5."""
        if n <= 0:
            return 0.0

        def ev(node) -> float:
            if isinstance(node, ast.BoolOp):
                parts = [ev(v) for v in node.values]
                if isinstance(node.op, ast.And):
                    out = 1.0
                    for p in parts:
                        out *= p
                else:
                    out = 1.0
                    for p in parts:
                        out *= 1.0 - p
                    out = 1.0 - out
                return out
            if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
                return 1.0 - ev(node.operand)
            if isinstance(node, ast.Compare):
                field, op, value = self._leaf(node)
                idx = attr_indexes.get(field)
                if idx is None:
                    return 0.5
                return idx.op_count(op, value) / n
            raise ValueError(f"unsupported node {node!r}")

        return float(min(1.0, max(0.0, ev(self.tree))))
