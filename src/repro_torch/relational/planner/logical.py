"""Logical operator DAG + the expression language plans are written in.

The IR is deliberately small — exactly the operators the paper's TPC-H
evaluation needs (HyPer's pipeline set): ``Scan``, ``Filter``, ``Project``,
``HashJoin`` (PK build side), ``GroupBy`` (dense pre-aggregating or
sort-based), scalar ``Aggregate``, and ``TopK``.  Nodes are frozen
dataclasses; a node used by two consumers (e.g. Q17's partitioned lineitem
feeding both the correlated-AVG group-by and the probe of the join back)
makes the plan a DAG, and both the physical planner and the executor
memoize on node identity so shared pipelines are planned and executed once.

Expressions (:class:`Expr`) are declarative — ``col("l_quantity") < lit(24)``
— so the physical planner can render them deterministically in ``explain()``
(the golden-snapshot surface) and the executor can evaluate them against a
mask-carrying :class:`~repro.relational.table.Table`.  Python operator
overloads build the tree; ``eval`` maps onto torch (the only part of this
module that differs from ``repro.relational.planner.logical``).

Schema inference is structural (every node exposes ``.schema``); cardinality
inference (``est_rows``) propagates the *static capacity* bound from a
catalog of base-table row counts — capacities, not expected selectivities,
because capacities are what size the zero-drop exchange buffers and what
the paper's broadcast-threshold rule compares (§3.1).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Mapping

import numpy as np
import torch

from ..table import Table

# ----------------------------------------------------------------------------
# Expression language.
# ----------------------------------------------------------------------------

_DTYPES = {"f32": torch.float32, "i32": torch.int32}


class Expr:
    """Base class: a scalar-per-row expression over a Table's columns."""

    def eval(self, t: Table) -> torch.Tensor:
        raise NotImplementedError

    def render(self) -> str:
        raise NotImplementedError

    def columns(self) -> frozenset[str]:
        """Column names this expression reads (for pruning checks)."""
        raise NotImplementedError

    def is_float(self, float_cols: frozenset[str]) -> bool:
        """Whether this expression produces a float column, given which of
        the input columns are float.  The physical planner uses this to
        know which schemas can still go through the int32 row-image
        exchange (float aggregates must stay local)."""
        raise NotImplementedError

    def f32(self) -> "Expr":
        return Cast(self, "f32")

    # -- operator overloads (non-Expr operands become literals) -------------
    def __add__(self, o):
        return Bin("+", self, _wrap(o))

    def __radd__(self, o):
        return Bin("+", _wrap(o), self)

    def __sub__(self, o):
        return Bin("-", self, _wrap(o))

    def __rsub__(self, o):
        return Bin("-", _wrap(o), self)

    def __mul__(self, o):
        return Bin("*", self, _wrap(o))

    def __rmul__(self, o):
        return Bin("*", _wrap(o), self)

    def __truediv__(self, o):
        return Bin("/", self, _wrap(o))

    def __lt__(self, o):
        return Bin("<", self, _wrap(o))

    def __le__(self, o):
        return Bin("<=", self, _wrap(o))

    def __gt__(self, o):
        return Bin(">", self, _wrap(o))

    def __ge__(self, o):
        return Bin(">=", self, _wrap(o))

    def eq(self, o):  # __eq__ would break hashing/dataclass equality
        return Bin("==", self, _wrap(o))

    def ne(self, o):
        return Bin("!=", self, _wrap(o))

    def __and__(self, o):
        return Bin("&", self, _wrap(o))

    def __or__(self, o):
        return Bin("|", self, _wrap(o))


@dataclasses.dataclass(frozen=True)
class Col(Expr):
    name: str

    def eval(self, t: Table) -> torch.Tensor:
        return t[self.name]

    def render(self) -> str:
        return self.name

    def columns(self) -> frozenset[str]:
        return frozenset((self.name,))

    def is_float(self, float_cols: frozenset[str]) -> bool:
        return self.name in float_cols


@dataclasses.dataclass(frozen=True)
class Lit(Expr):
    value: float | int | bool

    def eval(self, t: Table):
        return self.value

    def render(self) -> str:
        return repr(self.value)

    def columns(self) -> frozenset[str]:
        return frozenset()

    def is_float(self, float_cols: frozenset[str]) -> bool:
        return isinstance(self.value, float)


_OPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "&": lambda a, b: a & b,
    "|": lambda a, b: a | b,
}


@dataclasses.dataclass(frozen=True)
class Bin(Expr):
    op: str
    lhs: Expr
    rhs: Expr

    def eval(self, t: Table):
        return _OPS[self.op](self.lhs.eval(t), self.rhs.eval(t))

    def render(self) -> str:
        return f"({self.lhs.render()} {self.op} {self.rhs.render()})"

    def columns(self) -> frozenset[str]:
        return self.lhs.columns() | self.rhs.columns()

    def is_float(self, float_cols: frozenset[str]) -> bool:
        if self.op == "/":
            return True  # true division promotes to float
        if self.op in ("<", "<=", ">", ">=", "==", "!=", "&", "|"):
            return False  # boolean result
        return self.lhs.is_float(float_cols) or self.rhs.is_float(float_cols)


@dataclasses.dataclass(frozen=True)
class Cast(Expr):
    child: Expr
    dtype: str  # "f32" | "i32"

    def eval(self, t: Table):
        return torch.as_tensor(self.child.eval(t), device=t.device).to(_DTYPES[self.dtype])

    def render(self) -> str:
        return f"{self.dtype}({self.child.render()})"

    def columns(self) -> frozenset[str]:
        return self.child.columns()

    def is_float(self, float_cols: frozenset[str]) -> bool:
        return self.dtype == "f32"


@dataclasses.dataclass(frozen=True)
class Where(Expr):
    cond: Expr
    then: Expr
    other: Expr

    def eval(self, t: Table):
        return _where(self.cond.eval(t), self.then.eval(t), self.other.eval(t))

    def render(self) -> str:
        return (
            f"where({self.cond.render()}, {self.then.render()}, "
            f"{self.other.render()})"
        )

    def columns(self) -> frozenset[str]:
        return self.cond.columns() | self.then.columns() | self.other.columns()

    def is_float(self, float_cols: frozenset[str]) -> bool:
        return (
            self.then.is_float(float_cols) or self.other.is_float(float_cols)
        )


def _where(cond, then, other):
    """A where with the reference's weak typing: two Python scalars give an
    int32 (or f32) column, not torch's int64 (or f64) default."""
    if not isinstance(then, torch.Tensor) and not isinstance(other, torch.Tensor):
        dtype = torch.float32 if isinstance(then, float) or isinstance(other, float) \
            else torch.int32
        then = torch.tensor(then, dtype=dtype, device=cond.device)
    return torch.where(cond, then, other)


def _wrap(v) -> Expr:
    return v if isinstance(v, Expr) else Lit(v)


def col(name: str) -> Col:
    return Col(name)


def lit(v) -> Lit:
    return Lit(v)


def where(cond: Expr, then, other) -> Where:
    return Where(cond, _wrap(then), _wrap(other))


def predicate_selectivity(pred: Expr, sample: Mapping[str, "np.ndarray"]) -> float:
    """Fraction of ``sample`` rows passing ``pred`` — the estimation side of
    the expression language.

    ``sample`` maps column names to equal-length numpy arrays (a statistics
    sample, see :mod:`repro.relational.stats`); the predicate is evaluated
    with the exact same ``Expr.eval`` the executor uses, so the estimate and
    the runtime filter can never disagree on semantics.  An empty sample
    returns 1.0 (no evidence to prune on — keep the conservative capacity).
    """
    cols = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sample.items()}
    n = next(iter(cols.values())).shape[0] if cols else 0
    if n == 0:
        return 1.0
    t = Table(cols, torch.ones((n,), dtype=torch.bool))
    mask = torch.as_tensor(pred.eval(t)).numpy().astype(bool)
    return float(mask.mean())


# ----------------------------------------------------------------------------
# Logical operators.
# ----------------------------------------------------------------------------

AggKind = Literal["sum", "count"]
# (output name, input expression, kind); count ignores the expression
AggSpec = tuple[str, Expr, AggKind]

Catalog = Mapping[str, int]  # base table name -> row count (capacity)


class Node:
    """Base logical operator; subclasses are frozen dataclasses."""

    @property
    def schema(self) -> tuple[str, ...]:
        raise NotImplementedError

    def children(self) -> tuple["Node", ...]:
        raise NotImplementedError

    def est_rows(self, catalog: Catalog) -> int:
        """Static row-capacity bound flowing out of this operator."""
        raise NotImplementedError


def _assert_streaming(child: "Node", op: str) -> None:
    """Root-only combines (dense GroupBy / Aggregate / TopK) produce a
    cross-shard-combined result, not a row stream — consuming one from
    another operator is an illegal plan shape; reject it at construction
    instead of failing inside jit tracing."""
    root_only = isinstance(child, (Aggregate, TopK)) or (
        isinstance(child, GroupBy) and child.num_groups is not None
    )
    if root_only:
        raise TypeError(
            f"{op} cannot consume {type(child).__name__}: dense/scalar "
            "combines are root-only (their psum/top-k merge already "
            "crossed shards)"
        )


@dataclasses.dataclass(frozen=True)
class Scan(Node):
    """Read a base table, pruned to ``columns`` (paper §3.2.1: prune before
    anything ships)."""

    table: str
    columns: tuple[str, ...]

    @property
    def schema(self) -> tuple[str, ...]:
        return self.columns

    def children(self):
        return ()

    def est_rows(self, catalog: Catalog) -> int:
        return int(catalog[self.table])


@dataclasses.dataclass(frozen=True)
class Filter(Node):
    """Selection vector: AND ``pred`` into the validity mask (no movement)."""

    child: Node
    pred: Expr

    def __post_init__(self):
        _assert_streaming(self.child, "Filter")
        missing = self.pred.columns() - set(self.child.schema)
        assert not missing, f"Filter reads unknown columns {sorted(missing)}"

    @property
    def schema(self) -> tuple[str, ...]:
        return self.child.schema

    def children(self):
        return (self.child,)

    def est_rows(self, catalog: Catalog) -> int:
        return self.child.est_rows(catalog)


@dataclasses.dataclass(frozen=True)
class Project(Node):
    """Keep ``keep`` columns and append ``derived`` computed columns."""

    child: Node
    keep: tuple[str, ...]
    derived: tuple[tuple[str, Expr], ...] = ()

    def __post_init__(self):
        _assert_streaming(self.child, "Project")
        have = set(self.child.schema)
        missing = set(self.keep) - have
        for _, e in self.derived:
            missing |= e.columns() - have
        assert not missing, f"Project reads unknown columns {sorted(missing)}"

    @property
    def schema(self) -> tuple[str, ...]:
        return self.keep + tuple(n for n, _ in self.derived)

    def children(self):
        return (self.child,)

    def est_rows(self, catalog: Catalog) -> int:
        return self.child.est_rows(catalog)


@dataclasses.dataclass(frozen=True)
class HashJoin(Node):
    """PK-FK join: ``build`` has unique keys, ``probe`` rows survive with
    ``payload`` build columns attached (non-matches masked out).

    The physical planner decides broadcast-vs-partition for the build side
    with the paper's hybrid threshold (§3.1) — the join itself is strategy-
    agnostic, which is the whole point of the IR.
    """

    build: Node
    probe: Node
    build_key: str
    probe_key: str
    payload: tuple[str, ...] = ()

    def __post_init__(self):
        _assert_streaming(self.build, "HashJoin (build)")
        _assert_streaming(self.probe, "HashJoin (probe)")
        assert self.build_key in self.build.schema, self.build_key
        assert self.probe_key in self.probe.schema, self.probe_key
        missing = set(self.payload) - set(self.build.schema)
        assert not missing, f"payload not in build schema: {sorted(missing)}"

    @property
    def schema(self) -> tuple[str, ...]:
        return self.probe.schema + self.payload

    def children(self):
        return (self.build, self.probe)

    def est_rows(self, catalog: Catalog) -> int:
        return self.probe.est_rows(catalog)


@dataclasses.dataclass(frozen=True)
class GroupBy(Node):
    """Group-by aggregation, two physical flavors picked by ``num_groups``:

    * ``num_groups is None`` — sort-based over a large key domain
      (``key`` column); output is a group table (key + aggregates), hash-
      partitioned on the key.  Forces co-partitioning on ``key``.
    * ``num_groups = G`` — dense pre-aggregation over a small domain
      (``key_expr`` computes the group id): each shard reduces locally into
      ``G`` cells and the cross-shard combine is a psum of the tiny group
      table, not a shuffle of raw rows (paper Fig 6c).  Root-only.
    """

    child: Node
    aggs: tuple[AggSpec, ...]
    key: str | None = None
    key_expr: Expr | None = None
    num_groups: int | None = None

    def __post_init__(self):
        _assert_streaming(self.child, "GroupBy")
        have = set(self.child.schema)
        if self.num_groups is None:
            assert self.key in have, self.key
        else:
            assert self.key_expr is not None, "dense GroupBy needs key_expr"
            missing = self.key_expr.columns() - have
            assert not missing, (
                f"key_expr reads unknown columns {sorted(missing)}"
            )
        for _, e, _k in self.aggs:
            missing = e.columns() - have
            assert not missing, f"agg reads unknown columns {sorted(missing)}"

    @property
    def schema(self) -> tuple[str, ...]:
        names = tuple(n for n, _, _ in self.aggs)
        return ((self.key,) + names) if self.num_groups is None else names

    def children(self):
        return (self.child,)

    def est_rows(self, catalog: Catalog) -> int:
        if self.num_groups is not None:
            return self.num_groups
        return self.child.est_rows(catalog)  # worst case: all keys distinct


@dataclasses.dataclass(frozen=True)
class Aggregate(Node):
    """Scalar aggregates over the whole input; combine is a psum. Root-only."""

    child: Node
    aggs: tuple[AggSpec, ...]

    def __post_init__(self):
        _assert_streaming(self.child, "Aggregate")
        have = set(self.child.schema)
        for _, e, _k in self.aggs:
            missing = e.columns() - have
            assert not missing, f"agg reads unknown columns {sorted(missing)}"

    @property
    def schema(self) -> tuple[str, ...]:
        return tuple(n for n, _, _ in self.aggs)

    def children(self):
        return (self.child,)

    def est_rows(self, catalog: Catalog) -> int:
        return 1


@dataclasses.dataclass(frozen=True)
class TopK(Node):
    """Top-``k`` rows by ``key`` (descending): local top-k per shard, then a
    broadcast combine of the tiny candidate set. Root-only."""

    child: Node
    key: str
    k: int
    payload: tuple[str, ...]

    def __post_init__(self):
        _assert_streaming(self.child, "TopK")
        have = set(self.child.schema)
        assert self.key in have, self.key
        missing = set(self.payload) - have
        assert not missing, f"payload not in schema: {sorted(missing)}"

    @property
    def schema(self) -> tuple[str, ...]:
        return self.payload

    def children(self):
        return (self.child,)

    def est_rows(self, catalog: Catalog) -> int:
        return self.k


def scans_of(root: Node) -> tuple[Scan, ...]:
    """Every distinct Scan in the DAG, in deterministic first-visit order."""
    seen: dict[int, Scan] = {}
    out: list[Scan] = []

    def walk(n: Node):
        if id(n) in seen:
            return
        seen[id(n)] = n  # type: ignore[assignment]
        if isinstance(n, Scan):
            out.append(n)
        for c in n.children():
            walk(c)

    walk(root)
    return tuple(out)


__all__ = [
    "Expr",
    "Col",
    "Lit",
    "Bin",
    "Cast",
    "Where",
    "col",
    "lit",
    "where",
    "AggSpec",
    "Catalog",
    "Node",
    "Scan",
    "Filter",
    "Project",
    "HashJoin",
    "GroupBy",
    "Aggregate",
    "TopK",
    "scans_of",
]
